"""``python -m tpuserver_torch.bench_prefill_sweep`` against the JAX
package's ``tools/bench_prefill_sweep.py`` on the CPU.

The identity arm is the one whose numbers a CPU run can hold to JAX's:
on float32 ``tiny`` with JAX's weights, the port's chained prompts and
every prefill's logits equal the JAX tool's ``time_prefill`` with
``tpuserver.ops.flash_attention`` patched to the identity, as its arm
patches it.  The JAX tool is loaded by path and not edited; its prefills
are read by wrapping its ``jax.jit``."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserver
import tpuserver.ops as jax_ops
from tpuserver.models import llama as jl
from tpuserver_torch import bench_prefill_sweep as sweep
from tpuserver_torch.models import llama as tl
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_prefill_sweep.py")
T, MAX_SEQ, ROUNDS = 128, 256, 2


def _load_jax_tool(path, name):
    """The JAX tool at ``path`` as a module, its compile cache left
    unset (the tools point it at the repo at import)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tpuserver, "enable_compile_cache", lambda path=None: path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    return module


@pytest.fixture(scope="module")
def jax_tool():
    return _load_jax_tool(TOOL, "jax_bench_prefill_sweep")


@pytest.fixture(scope="module")
def tiny256():
    """(JAX float32 ``tiny``, the port's, the port's weights bridged
    from JAX's ``init_params(PRNGKey(0))``, JAX's): vocab 256, the
    tool's ``--config tiny``."""
    jcfg = dataclasses.replace(jl.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny(), dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, tparams, jparams


def _jax_row_keys():
    """The key set of each row literal the JAX tool prints, by phase
    (error lines apart)."""
    with open(TOOL) as fh:
        tree = ast.parse(fh.read())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys}
            if "phase" in names and "error" not in names:
                phase = next(v.value for k, v in zip(node.keys, node.values)
                             if k.value == "phase")
                keys[phase] = names
    return keys


def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_identity_arm_prompts_and_logits_equal_jax(jax_tool, tiny256,
                                                   monkeypatch):
    jcfg, tcfg, tparams, jparams = tiny256
    arm = next(a for a in sweep.PREFILL_ARMS
               if a[0] == "attention_identity")
    seed0 = 1000 * (sweep.PREFILL_ARMS.index(arm) + 1)

    jax_calls = []

    def recording_jit(fn, **kwargs):
        jitted = jax.jit(fn, **kwargs)

        def call(params, cache, tokens):
            lg, cache = jitted(params, cache, tokens)
            jax_calls.append((np.asarray(tokens), np.asarray(lg)))
            return lg, cache

        return call

    # the JAX arm, as its tool runs it: flash patched in the ops module
    jcfg_arm = dataclasses.replace(jcfg, attn_impl="pallas",
                                   flash_block_q=128, flash_block_k=128)
    monkeypatch.setattr(jax_tool, "jax", types.SimpleNamespace(
        jit=recording_jit))
    monkeypatch.setattr(jax_ops, "flash_attention",
                        lambda q, k, v, **kw: q)
    jax_tool.time_prefill(jcfg_arm, jparams, T, MAX_SEQ, ROUNDS, seed0)
    monkeypatch.undo()

    port_calls = []
    real_prefill = tl.prefill

    def recording_prefill(params, cache, tokens, cfg):
        lg, cache = real_prefill(params, cache, tokens, cfg)
        port_calls.append((tokens.numpy().copy(), lg.numpy().copy()))
        return lg, cache

    real_flash = tl.flash_attention
    monkeypatch.setattr(tl, "prefill", recording_prefill)
    sweep.prefill_arm(tcfg, tparams, arm, T, MAX_SEQ, ROUNDS, seed0,
                      device="cpu")
    assert tl.flash_attention is real_flash
    assert len(port_calls) == len(jax_calls) == ROUNDS + 2
    for (toks, lg), (jtoks, jlg) in zip(port_calls, jax_calls):
        np.testing.assert_array_equal(toks, jtoks)
        np.testing.assert_allclose(lg, jlg, rtol=0, atol=1e-4)
    # the identity arm differs from real attention: the patch took effect
    dense_arm = next(a for a in sweep.PREFILL_ARMS if a[0] == "dense")
    port_calls.clear()
    sweep.prefill_arm(tcfg, tparams, dense_arm, T, MAX_SEQ, ROUNDS, seed0,
                      device="cpu")
    assert not np.allclose(port_calls[0][1], jax_calls[0][1], atol=1e-2)


def test_the_flash_binding_is_restored_after_a_failing_arm(tiny256,
                                                           monkeypatch):
    """An arm that raises prints the JAX tool's error row, and the next
    arms run with the model's own flash call."""
    _, tcfg, tparams, _ = tiny256
    real_flash = tl.flash_attention
    seen = []

    def time_prefill(cfg, *args, **kwargs):
        seen.append(tl.flash_attention)
        if tl.flash_attention is not real_flash:
            raise RuntimeError("planted failure")
        return 0.001

    monkeypatch.setattr(sweep, "time_prefill", time_prefill)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert sweep.main(["--config", "tiny", "--t", "128", "--rounds",
                           "1", "--prefill-only", "--device", "cpu"],
                          params=tparams) == 0
    assert tl.flash_attention is real_flash
    assert seen[:5] == [real_flash] * 5 and seen[5] is not real_flash
    rows = _rows(out.getvalue())
    assert [r["arm"] for r in rows] == [a[0] for a in sweep.PREFILL_ARMS]
    assert rows[-1] == {"phase": "prefill", "arm": "attention_identity",
                        "error": "planted failure"}


def test_main_prints_six_prefill_and_sixteen_decode_rows(tiny256):
    _, _, tparams, _ = tiny256
    real_flash = tl.flash_attention
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sweep.main(["--config", "tiny", "--t", "128", "--rounds", "1",
                         "--device", "cpu"], params=tparams)
    assert rc == 0
    assert tl.flash_attention is real_flash
    rows = _rows(out.getvalue())
    want = _jax_row_keys()
    prefill = [r for r in rows if r["phase"] == "prefill"]
    decode = [r for r in rows if r["phase"] == "decode"]
    assert len(prefill) == 6 and len(decode) == 16 and len(rows) == 22
    for row in rows:
        assert set(row) == want[row["phase"]], row
        assert "error" not in row
    assert [r["arm"] for r in prefill] == [a[0] for a in sweep.PREFILL_ARMS]
    assert {(r["weights"], r["impl"], r["chunk"]) for r in decode} == {
        (w, i, c) for w in ("bf16", "int8") for i in ("dense", "auto")
        for c in (32, 64)}
    for row in rows:
        value = row.get("ms", row.get("tokens_per_sec"))
        assert np.isfinite(value) and value > 0
        assert row["mfu" if row["phase"] == "prefill" else "mbu"] is None
    # the decode arms' contexts: the middle of two 32- or 64-token chunks
    assert {r["ctx"] for r in decode} == {544, 2080, 576, 2112}
    assert set(sweep.STATS["prefill"]) == {a[0] for a in sweep.PREFILL_ARMS}
    assert len(sweep.STATS["decode"]) == 16


def test_params_must_match_the_config(tiny256):
    _, _, tparams, _ = tiny256
    with pytest.raises(ValueError, match="do not match"):
        sweep.main(["--config", "llama3_1b", "--device", "cpu"],
                   params=tparams)


def test_the_run_takes_the_depth_of_the_callers_params(tiny256,
                                                       monkeypatch):
    """A caller's tree cut in depth (the first layer of ``tiny``) runs
    at that depth: the prefill FLOPs of the rows count one layer."""
    _, _, tparams, _ = tiny256
    shallow = dict(tparams, layers=tparams["layers"][:1])
    seen = []
    real = sweep.perf.prefill_flops
    monkeypatch.setattr(sweep.perf, "prefill_flops",
                        lambda cfg, t: seen.append(cfg) or real(cfg, t))
    with contextlib.redirect_stdout(io.StringIO()):
        assert sweep.main(["--config", "tiny", "--t", "128", "--rounds",
                           "1", "--prefill-only", "--device", "cpu"],
                          params=shallow) == 0
    assert [c.n_layers for c in seen] == [1]
    assert seen[0].dtype == torch.float32
