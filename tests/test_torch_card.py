"""The port's CUDA kernels held against their plain PyTorch versions on
the card.  These need a CUDA device and skip without one; they import no
JAX, so they run where the port runs:

    PYTHONPATH=src/python python -m pytest --noconftest tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have.)
"""

import pytest
import torch

from tpuserver_torch.ops import _build
from tpuserver_torch.ops import flash as tflash

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# Row-relative limits (as in chip_smoke.py): the largest |kernel - plain|
# of each output row over that row's largest |plain|.  bf16 rounds both
# sides to 8 mantissa bits (one ulp is at most 2^-7 of the row's largest
# value); float32 differs only in the order of summation.
CARD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _row_rel_err(out, ref):
    diff = (out.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    return (diff / scale).max().item()


@pytest.mark.parametrize("d,causal", [(128, True), (128, False),
                                      (64, True), (64, False)])
def test_flash_kernel_matches_plain_on_card(cuda, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 200, hh, d, device=cuda, generator=gen).to(
        torch.bfloat16) for hh in (8, 2, 2))
    before = tflash.flash_attention.launches
    out = tflash.flash_attention(q, k, v, causal=causal, block_q=8,
                                 block_k=8)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    ref = tflash.flash_attention_reference(q, k, v, causal=causal)
    assert _row_rel_err(out, ref) <= CARD_TOL[torch.bfloat16]
    # the limit sees a wrong kv head
    wrong = tflash.flash_attention_reference(
        q, k.roll(1, dims=2), v.roll(1, dims=2), causal=causal)
    assert _row_rel_err(wrong, ref) > CARD_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 8),
                                     (torch.bfloat16, 96)])
def test_flash_kernel_rejects_what_it_does_not_take(cuda, dtype, d):
    q = torch.zeros(1, 64, 4, d, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="bfloat16 operands with head dim"):
        tflash.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype,h,hkv,d", [
    (torch.bfloat16, 32, 8, 128), (torch.bfloat16, 8, 8, 64),
    (torch.float32, 6, 2, 16), (torch.bfloat16, 8, 1, 8)])
def test_decode_kernel_matches_plain_on_card(cuda, dtype, h, hkv, d):
    gen = torch.Generator(device=cuda).manual_seed(1)
    lengths = torch.tensor([0, 1, 300, 512], dtype=torch.int32, device=cuda)
    q = torch.randn(4, h, d, device=cuda, generator=gen).to(dtype)
    kc = torch.randn(4, 512, hkv, d, device=cuda, generator=gen).to(dtype)
    vc = torch.randn(4, 512, hkv, d, device=cuda, generator=gen).to(dtype)
    before = tflash.decode_attention.launches
    out = tflash.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert tflash.decode_attention.launches == before + 1
    ref = tflash.decode_attention_reference(q, kc, vc, lengths)
    assert _row_rel_err(out, ref) <= CARD_TOL[dtype]
    assert not out[0].any()
    # the limit sees the last 256-key tile skipped
    short = tflash.decode_attention_reference(
        q, kc, vc, torch.where(lengths > 256, lengths - 256, lengths))
    assert _row_rel_err(short, ref) > CARD_TOL[dtype]


def test_cuda_wrappers_raise_without_a_library(cuda, monkeypatch, tmp_path):
    """No silent fallback: with no kernel library, a CUDA call raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    _build.load_library.cache_clear()
    try:
        q = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
        before = (tflash.flash_attention.launches,
                  tflash.decode_attention.launches)
        with pytest.raises(RuntimeError, match="nvcc"):
            tflash.flash_attention(q, q, q)
        with pytest.raises(RuntimeError, match="nvcc"):
            tflash.decode_attention(
                q[:, 0], q, q, torch.ones(1, dtype=torch.int32, device=cuda))
        assert before == (tflash.flash_attention.launches,
                          tflash.decode_attention.launches)
    finally:
        _build.load_library.cache_clear()
