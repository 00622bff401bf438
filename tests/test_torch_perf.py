"""The port's roofline module (tpuserver_torch.ops.perf) held against the
JAX package's (tpuserver.ops.perf): every counter equal on the ``tiny``
and ``llama3_8b`` presets, each built from its own package's presets (no
weights needed), and the spec table's CPU answers.  Counts are integers
and must be equal; the ratios are checked exactly on a made-up spec."""

import pytest

from tpuserver.models import llama as jl
from tpuserver.ops import perf as jp
from tpuserver_torch.models import llama as tl
from tpuserver_torch.ops import perf as tp

pytestmark = pytest.mark.torch_port

PRESETS = ["tiny", "llama3_8b"]


@pytest.mark.parametrize("preset", PRESETS)
def test_counters_match_jax(preset):
    jcfg, tcfg = getattr(jl, preset)(), getattr(tl, preset)()
    assert tp.param_count(tcfg) == jp.param_count(jcfg)
    assert tp.matmul_params(tcfg) == jp.matmul_params(jcfg)
    for ctx in (0, 1, 576, 4096):
        assert tp.decode_flops_per_token(tcfg, ctx) == \
            jp.decode_flops_per_token(jcfg, ctx)
        for wb in (None, 1, 2):
            assert tp.decode_bytes_per_token(
                tcfg, ctx, weight_bytes_per_param=wb) == \
                jp.decode_bytes_per_token(jcfg, ctx,
                                          weight_bytes_per_param=wb)
        assert tp.decode_bytes_per_token(tcfg, ctx, dtype_bytes=4) == \
            jp.decode_bytes_per_token(jcfg, ctx, dtype_bytes=4)
    for t in (1, 7, 512, 2048):
        assert tp.prefill_flops(tcfg, t) == jp.prefill_flops(jcfg, t)


def test_llama3_8b_counts():
    """The 8B preset's matmul weights: 7.50 G parameters, so one int8
    decode token reads about half the bytes of a bf16 one."""
    cfg = tl.llama3_8b()
    assert tp.param_count(cfg) == 8030261248
    assert tp.matmul_params(cfg) == 7504924672
    bf16 = tp.decode_bytes_per_token(cfg, 576)
    int8 = tp.decode_bytes_per_token(cfg, 576, weight_bytes_per_param=1)
    assert bf16 - int8 == tp.matmul_params(cfg)


def test_bert_encoder_flops_match_jax():
    assert tp.bert_encoder_flops() == jp.bert_encoder_flops()
    assert tp.bert_encoder_flops(64, 256, 2, 512) == \
        jp.bert_encoder_flops(64, 256, 2, 512)


def test_chip_spec_is_none_on_the_cpu():
    assert tp.chip_spec() is None
    assert tp.chip_spec("cpu") is None
    spec = tp.CHIP_SPECS["NVIDIA H100 80GB HBM3"]
    assert (spec.peak_bf16_flops, spec.hbm_bandwidth, spec.hbm_bytes) == (
        989e12, 3.35e12, 80 << 30)
    # no TPU row: the table holds only the port's cards
    assert not any(k.startswith("TPU") for k in tp.CHIP_SPECS)


def test_mfu_and_mbu():
    assert tp.mfu(1e12, 1.0, None) is None
    assert tp.mbu(1e12, 1.0, None) is None
    spec = tp.ChipSpec("test", 1e12, 2e12, 1 << 30)
    assert tp.mfu(1e12, 0.0, spec) is None
    assert tp.mbu(1e12, -1.0, spec) is None
    assert tp.mfu(5e11, 1.0, spec) == 0.5
    assert tp.mbu(5e11, 1.0, spec) == 0.25
    jspec = jp.ChipSpec("test", 1e12, 2e12, 1 << 30)
    for f in (3.3e11, 7e12):
        assert tp.mfu(f, 0.7, spec) == jp.mfu(f, 0.7, jspec)
        assert tp.mbu(f, 0.7, spec) == jp.mbu(f, 0.7, jspec)
