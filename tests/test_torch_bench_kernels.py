"""``python -m tpuserver_torch.bench_kernels`` against the JAX package's
``tools/bench_kernels.py`` on the CPU, and the three model-path tuning
tools' isolation from the JAX side.

The JAX tool is loaded by path and not edited.  Its dense arms are held
against the port's on the same numpy inputs; both tools' sweeps run at a
small shape (T 128, two heads, d 64, chains of 1 and 3) and print rows
whose keys are compared; the FLOP and byte counts each tool hands to
``perf.mfu``/``perf.mbu`` are compared at the sweep's own shapes, with
the timing stubbed out (``_time_scanned``)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserver
from tpuserver.ops import flash_attention as jax_flash_attention
from tpuserver_torch import bench_kernels as port
from tpuserver_torch import bench_prefill_sweep, bench_speculative
from tpuserver_torch.ops import flash as fl
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PY = os.path.join(REPO, "src", "python")
TOOL = os.path.join(REPO, "tools", "bench_kernels.py")
# the row keys' and values' names for the TPU path, and the port's
RENAMED = {"pallas_speedup": "kernel_speedup", "xla_dense": "torch_dense",
           "pallas_flash": "cuda_flash", "pallas_decode": "cuda_decode"}


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
    return _load_jax_tool(TOOL, "jax_bench_kernels")


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _rows(text):
    """The JSON lines of ``text``, with the TPU path's names replaced by
    the port's."""
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            out.append({RENAMED.get(k, k): RENAMED.get(v, v)
                        if isinstance(v, str) else v
                        for k, v in row.items()})
    return out


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attn_matches_jax(jax_tool, causal):
    q, k, v = (_randn(s, (1, 64, 4, 32)) for s in (1, 2, 3))
    want = np.asarray(jax_tool._dense_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = port._dense_attn(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("lengths", [(1,), (37,), (128,), (5, 90)])
def test_dense_decode_matches_jax(jax_tool, lengths):
    b = len(lengths)
    q = _randn(4, (b, 8, 32))
    kc, vc = _randn(5, (b, 128, 2, 32)), _randn(6, (b, 128, 2, 32))
    length = np.asarray(lengths, np.int32)
    want = np.asarray(jax_tool._dense_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(length)))
    got = port._dense_decode(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(length))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_kernel_entries_match_their_plain_arms_and_jax():
    """The tool's kernel calls (flash at its 256 tiles, decode at
    block_k 256) on CPU tensors: the kernels' plain versions, equal to
    the tool's dense arms and to the JAX Pallas kernel in interpret
    mode."""
    q, k, v = (_randn(s, (1, 256, 2, 64)) for s in (7, 8, 9))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    flash = port.flash_attention(tq, tk, tv, causal=True, block_q=256,
                                 block_k=256)
    np.testing.assert_allclose(flash.numpy(),
                               port._dense_attn(tq, tk, tv).numpy(),
                               rtol=0, atol=1e-5)
    pallas = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=128, block_k=128))
    np.testing.assert_allclose(flash.numpy(), pallas, rtol=0, atol=1e-5)
    qd = torch.from_numpy(_randn(10, (1, 4, 64)))
    kc, vc = (torch.from_numpy(_randn(s, (1, 512, 2, 64))) for s in (11, 12))
    length = torch.tensor([300], dtype=torch.int32)
    decode = port.decode_attention(qd, kc, vc, length, block_k=256)
    np.testing.assert_allclose(
        decode.numpy(), port._dense_decode(qd, kc, vc, length).numpy(),
        rtol=0, atol=1e-5)


def test_small_sweeps_print_the_jax_rows(jax_tool, capsys):
    """Both tools' ``bench_flash`` and ``bench_decode`` at a small shape
    on the CPU print the same rows, key for key and name for name (the
    TPU path's names apart), each time finite and positive.  The chains
    differ by 64 calls: a difference of two calls at these shapes lies
    inside a loaded CPU's timing noise, where every round can come out
    negative and the time NaN (in both tools)."""
    spec = None
    lens = (2, 66)
    jax_tool.bench_flash(128, 2, 64, lens, spec)
    jax_tool.bench_decode(256, 0.5, 4, 2, 64, lens, spec)
    theirs = _rows(capsys.readouterr().out)
    port.bench_flash(128, 2, 64, lens, spec, device="cpu")
    port.bench_decode(256, 0.5, 4, 2, 64, lens, spec, device="cpu")
    mine = _rows(capsys.readouterr().out)
    assert len(mine) == len(theirs) == 6
    for row, want in zip(mine, theirs):
        assert set(row) == set(want)
        for key in ("op", "T", "S", "valid", "heads", "d", "impl", "mfu",
                    "mbu"):
            assert row.get(key) == want.get(key)
        value = row.get("ms", row.get("us", row.get("kernel_speedup")))
        assert np.isfinite(value) and value > 0
    assert [r["impl"] for r in mine if "impl" in r] == [
        "torch_dense", "cuda_flash", "torch_dense", "cuda_decode"]


class _Draw:
    """Stands in for an array the JAX sweep draws (its values play no
    part in the counts)."""

    def standard_normal(self, shape):
        return self

    def astype(self, dtype):
        return self


def _jax_counts(jax_tool, monkeypatch):
    """The FLOPs and bytes the JAX sweep hands to ``perf.mfu`` and
    ``perf.mbu`` at its full shapes, with its draws and timings stubbed
    out."""
    seen = []
    monkeypatch.setattr(jax_tool, "_time_scanned", lambda *a, **kw: 1.0)
    monkeypatch.setattr(jax_tool, "np", types.SimpleNamespace(
        random=types.SimpleNamespace(RandomState=lambda seed: _Draw()),
        float32=np.float32))
    monkeypatch.setattr(jax_tool, "jnp", types.SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=None, int32=None))
    monkeypatch.setattr(jax_tool.perf, "mfu",
                        lambda flops, dt, spec: seen.append(flops) or 0.5)
    monkeypatch.setattr(jax_tool.perf, "mbu",
                        lambda nbytes, dt, spec: seen.append(nbytes) or 0.5)
    with contextlib.redirect_stdout(io.StringIO()):
        for T in port.FLASH_LENS:
            jax_tool.bench_flash(T, 16, 128, (1, 2), "spec")
        for S, frac in port.DECODE_CASES:
            jax_tool.bench_decode(S, frac, 16, 8, 128, (1, 2), "spec")
    monkeypatch.undo()
    return seen


def test_flop_and_byte_counts_equal_jax_at_the_sweep_shapes(jax_tool,
                                                           monkeypatch):
    """The sweep's shapes and chain lengths are JAX's, and at each the
    port's counts are the ones JAX's sweep reports with (flash: the
    dense and kernel rows share the FLOPs; decode: dense the padded
    cache, the kernel the live prefix)."""
    theirs = _jax_counts(jax_tool, monkeypatch)
    mine = []
    for T in port.FLASH_LENS:
        mine += [port.flash_flops(T, port.HEADS, port.HEAD_DIM)] * 2
    for S, frac in port.DECODE_CASES:
        live, padded = port.decode_bytes(S, frac, port.KV_HEADS,
                                         port.HEAD_DIM)
        mine += [padded, live]
    assert mine == theirs and len(mine) == 16
    assert (port.HEADS, port.KV_HEADS, port.HEAD_DIM) == (16, 8, 128)
    assert port.FLASH_LENS == {2048: (64, 1024), 8192: (8, 128),
                               32768: (1, 8)}
    assert port.DECODE_CASES == ((2048, 0.25), (8192, 0.25), (8192, 1.0),
                                 (32768, 0.25), (32768, 1.0))
    assert port.DECODE_LENS == (512, 8192)
    assert port.QUICK_FLASH_LENS == {2048: (64, 512)}
    assert port.QUICK_DECODE_CASES == ((2048, 0.5),)
    assert port.QUICK_DECODE_LENS == (512, 4096)


def test_the_sweep_reports_with_its_counts(monkeypatch):
    """The port's sweep hands ``flash_flops`` and ``decode_bytes`` to
    ``perf.mfu``/``perf.mbu`` (a small shape, a stand-in spec)."""
    seen = []
    monkeypatch.setattr(port.perf, "mfu",
                        lambda flops, dt, spec: seen.append(flops) or 0.5)
    monkeypatch.setattr(port.perf, "mbu",
                        lambda nbytes, dt, spec: seen.append(nbytes) or 0.5)
    with contextlib.redirect_stdout(io.StringIO()):
        port.bench_flash(128, 2, 64, (1, 2), "spec", device="cpu")
        port.bench_decode(256, 0.5, 4, 2, 64, (1, 2), "spec", device="cpu")
    live, padded = port.decode_bytes(256, 0.5, 2, 64)
    assert seen == [port.flash_flops(128, 2, 64)] * 2 + [padded, live]


def test_a_failing_dense_arm_still_prints_the_kernel_row(monkeypatch,
                                                         capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("CUDA out of memory (planted)")

    monkeypatch.setattr(port, "_dense_attn", broken)
    monkeypatch.setattr(port, "_dense_decode", broken)
    port.bench_flash(128, 2, 64, (1, 3), None, device="cpu")
    port.bench_decode(256, 0.5, 4, 2, 64, (1, 3), None, device="cpu")
    captured = capsys.readouterr()
    rows = _rows(captured.out)
    assert [(r["op"], r["impl"]) for r in rows] == [
        ("flash_attention", "cuda_flash"), ("decode_attention",
                                            "cuda_decode")]
    errors = [json.loads(line) for line in captured.err.splitlines()
              if line.startswith("{")]
    # the JAX tool's three attempts, each an error line
    assert [(e["op"], e["impl"], e["attempt"]) for e in errors] == [
        ("flash_attention", "torch_dense", a) for a in range(3)] + [
        ("decode_attention", "torch_dense", a) for a in range(3)]
    assert all(e["error"] == "CUDA out of memory (planted)"
               for e in errors)


@pytest.mark.parametrize("tool", [port, bench_prefill_sweep,
                                  bench_speculative])
def test_each_tool_needs_a_card_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])


def test_wrappers_count_no_launch_on_the_cpu():
    fl.reset_launch_counts()
    port.bench_decode(256, 0.5, 4, 2, 64, (1, 3), None, device="cpu")
    assert fl.decode_attention.launches == 0
    assert port.LAUNCHES == {
        name: {"counted": 0, "replayed": 0}
        for name in ("flash_attention", "decode_attention")}


def test_running_the_tools_imports_nothing_of_the_jax_side():
    """Each of the three tools, imported and run small in a fresh
    interpreter (each part of each tool that reaches another module),
    leaves no module of jax, tpuserver, perfanalyzer or tritonclient
    loaded."""
    script = (
        "import contextlib, io, sys, tempfile, os\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from tpuserver_torch import bench_kernels as bk\n"
        "from tpuserver_torch import bench_prefill_sweep as bp\n"
        "from tpuserver_torch import bench_speculative as bs\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    bk.bench_flash(128, 2, 64, (1, 2), None, device='cpu')\n"
        "    bk.bench_decode(256, 0.5, 4, 2, 64, (1, 2), None,\n"
        "                    device='cpu')\n"
        "    assert bp.main(['--config', 'tiny', '--t', '128',\n"
        "                    '--max-seq', '256', '--rounds', '1',\n"
        "                    '--prefill-only', '--device', 'cpu']) == 0\n"
        "    serve = bs.serving('tiny', 'cpu')\n"
        "    rows = []\n"
        "    bs.bench_agentic_regenerate(rows, serve)\n"
        "    bs.bench_perfanalyzer_column(rows, serve)\n"
        "assert len(rows) == 2, rows\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'tpuserver', 'perfanalyzer', 'tritonclient',\n"
        "              'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC_PY)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
