"""``python -m tpuserver_torch.bench_shm_data_plane`` against the JAX
package's ``tools/bench_shm_data_plane.py`` on the CPU.

Both run float32 ``tiny`` at vocab 256 on the same weights (JAX's
``init_params(PRNGKey(0))``, bridged to the port), at small counts set on
both: unary ``iters`` 8, generation 2 streams of 32 prompt tokens and 8
new ones, resume at a 64-token prompt.  The JAX tool is loaded by path
and not edited; its models draw ``llama.tiny``, which a fixture turns
float32.  Every generation either scheduler admits is recorded (prompt
and tokens) by wrapping ``DecodeScheduler.submit`` in both packages.
The port's ``cuda`` mode runs on CPU regions, which its in-process
server attaches."""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserver.scheduler as jax_scheduler
import tpuserver_torch.scheduler as port_scheduler
from tpuserver.models import llama as jl
from tpuserver_torch import bench_shm_data_plane as port
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.tree import tree_cast
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_shm_data_plane.py")
SMALL = {"bench_unary": {"iters": 8},
         "bench_generation": {"streams": 2, "prompt_len": 32,
                              "max_tokens": 8},
         "bench_resume_attach": {"prompt_len": 64}}
# the port's metric names for the JAX tool's, and the keys it adds
RENAMES = {"unary_infer_p50_xla": "unary_infer_p50_cuda",
           "generation_ttft_p50_xla_shm_ring":
               "generation_ttft_p50_cuda_shm_ring",
           "generation_itl_p50_xla_shm_ring":
               "generation_itl_p50_cuda_shm_ring"}
ADDED = {"generation": {"dtype"}, "resume": {"dtype"}}


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_shm_data_plane", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recording(mp, cls, log):
    """``cls.submit`` wrapped: each admission appends (prompt, tokens),
    its tokens filled in as they stream."""
    real = cls.submit

    def submit(self, prompt, max_tokens, *args, **kwargs):
        it = real(self, prompt, max_tokens, *args, **kwargs)
        tokens = []
        log.append((np.asarray(prompt).tolist(), tokens))

        def stream():
            try:
                for token, logprob in it:
                    tokens.append(int(token))
                    yield token, logprob
            finally:
                it.close()

        return stream()

    mp.setattr(cls, "submit", submit)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX tool's three parts at the small counts: its rows and the
    generations its schedulers admitted, by part."""
    tool = _load_jax_tool()
    real_tiny = jl.tiny
    mp = pytest.MonkeyPatch()
    mp.setattr(jl, "tiny", lambda vocab=256: dataclasses.replace(
        real_tiny(vocab), dtype=jnp.float32))
    rows, logs = [], {}
    try:
        for part in SMALL:
            log = logs.setdefault(part, [])
            with pytest.MonkeyPatch.context() as inner:
                _recording(inner, jax_scheduler.DecodeScheduler, log)
                with contextlib.redirect_stdout(io.StringIO()):
                    getattr(tool, part)(rows, **SMALL[part])
    finally:
        mp.undo()
    return rows, logs


@pytest.fixture(scope="module")
def tparams():
    cfg = dataclasses.replace(jl.tiny(vocab=256), dtype=jnp.float32)
    params = tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg)), "cpu")
    assert params["norm"].dtype == torch.float32
    return params


def _small_parts(mp, logs):
    """The port's parts at the small counts, each recording the
    generations its schedulers admit into ``logs[part]``."""
    for part, kwargs in SMALL.items():
        real = getattr(port, part)

        def run(*args, _real=real, _part=part, _kwargs=kwargs, **kw):
            with pytest.MonkeyPatch.context() as inner:
                _recording(inner, port_scheduler.DecodeScheduler,
                           logs.setdefault(_part, []))
                return _real(*args, **dict(kw, **_kwargs))

        mp.setattr(port, part, run)


def _main(argv, params):
    """``port.main(argv, params=)`` with its stdout and stderr captured:
    (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port.main(argv, params=params)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def port_run(tparams, tmp_path_factory):
    logs = {}
    out = tmp_path_factory.mktemp("shm") / "rows.json"
    mp = pytest.MonkeyPatch()
    _small_parts(mp, logs)
    try:
        rc, stdout, stderr = _main(["--out", str(out), "--device", "cpu"],
                                   tparams)
    finally:
        mp.undo()
    with open(out) as fh:
        payload = json.load(fh)
    return {"rc": rc, "logs": logs, "payload": payload, "stdout": stdout,
            "stderr": stderr}


def test_generation_tokens_equal_jax(jax_run, port_run):
    """Every generation stream (the warm-up and two streams in band, the
    same three from a CUDA region into the ring) admits JAX's prompt and
    streams JAX's tokens."""
    want = jax_run[1]["bench_generation"]
    got = port_run["logs"]["bench_generation"]
    assert len(want) == 6
    assert got == want
    assert all(len(tokens) == 8 for _, tokens in got)
    # the ring streams read their prompts from the region
    assert [p for p, _ in got[3:]] == [p for p, _ in got[:3]]


def test_resume_reference_equals_jax_and_both_modes_hold(jax_run, port_run):
    """The uninterrupted reference is JAX's, token for token; both modes'
    rows stand (every cycle's resume equal to the reference, checked
    inside the tool), and the run exits 0."""
    want = jax_run[1]["bench_resume_attach"]
    got = port_run["logs"]["bench_resume_attach"]
    assert got[0] == want[0] and len(got[0][1]) == 24
    # each cycle's head stream admits the same prompt
    assert len(got) == len(want) == 9
    assert {tuple(p) for p, _ in got} == {tuple(want[0][0])}
    assert port_run["rc"] == 0
    rows = {r["metric"]: r for r in port_run["payload"]["rows"]}
    for mode in ("reprefill", "attach"):
        row = rows["resume_first_live_token_" + mode]
        assert row["token_identical"] is True
        assert row["dtype"] == "float32" and row["value"] > 0


def test_rows_have_the_jax_keys(jax_run, port_run):
    """Nine rows, the JAX tool's metrics in its order (``xla`` named
    ``cuda``), each with its keys and, on the model rows, ``dtype``."""
    want = [dict(r, metric=RENAMES.get(r["metric"], r["metric"]))
            for r in jax_run[0]]
    got = port_run["payload"]["rows"]
    assert [r["metric"] for r in got] == [r["metric"] for r in want]
    for mine, theirs in zip(got, want):
        part = mine["metric"].split("_")[0]
        assert set(mine) == set(theirs) | ADDED.get(part, set()), \
            mine["metric"]
        for key in ("config", "unit", "transport", "tensor_bytes", "iters",
                    "streams", "prompt_tokens", "max_tokens", "head_tokens"):
            assert mine.get(key) == theirs.get(key), (mine["metric"], key)
    assert "wrote 9 rows" in port_run["stdout"]
    note = port_run["payload"]["note"]
    assert "tiny (2 layers) in float32 on cpu" in note
    assert "TPU" not in note and "XLA" not in note


def test_unary_cuda_mode_reads_the_region_in_process(monkeypatch):
    """The ``cuda`` mode registers a CPU region over HTTP with the server
    in the same process, which attaches it by its handle and reads every
    timed request's input from it without a copy (no cross-process
    path); the system mode copies."""
    cores = []

    class Recorded(port.InferenceServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            cores.append(self)

    monkeypatch.setattr(port, "InferenceServer", Recorded)
    rows = []
    results = port.bench_unary(rows, iters=4, device="cpu")
    assert set(results) == {"none", "system", "cuda"}
    assert [r["metric"] for r in rows] == [
        "unary_infer_p50_none", "unary_infer_p50_system",
        "unary_infer_p50_cuda"]
    assert all(r["value"] > 0 for r in rows)
    # the cuda mode's 4 warm-up and 4 timed requests, one input each
    assert cores[0].shm_stats()["shm_zero_copy_reads"] == 8


def test_planted_divergence_exits_one(tparams, tmp_path, monkeypatch):
    """A resume that does not match its reference (here a reference with
    its last token changed) prints FATAL and exits 1, writing nothing."""
    real = port._reference_tokens

    def wrong(*args):
        ref = real(*args)
        return ref[:-1] + [(ref[-1] + 1) % 256]

    monkeypatch.setattr(port, "_reference_tokens", wrong)
    monkeypatch.setattr(port, "bench_unary", lambda rows, **kw: None)
    monkeypatch.setattr(port, "bench_generation", lambda rows, serve: None)
    monkeypatch.setattr(port, "bench_resume_attach", functools.partial(
        port.bench_resume_attach, prompt_len=64))
    out = tmp_path / "rows.json"
    rc, _, stderr = _main(["--out", str(out), "--device", "cpu"], tparams)
    assert rc == 1
    assert "FATAL: reprefill resume diverged" in stderr
    assert not out.exists()


def test_an_attach_that_fell_back_exits_one(tparams, tmp_path,
                                            monkeypatch):
    """An attach mode whose resumes re-prefill (here its disconnects
    never park, so nothing is exported) streams the reference's tokens
    all the same: the scheduler's ``attach_admissions`` catch it, and the
    run prints FATAL and exits 1, writing nothing."""
    real = port._drive_stream

    def unparked(backend, inputs, params, take=None):
        return real(backend, inputs, dict(params, kv_park=False), take)

    monkeypatch.setattr(port, "_drive_stream", unparked)
    monkeypatch.setattr(port, "bench_unary", lambda rows, **kw: None)
    monkeypatch.setattr(port, "bench_generation", lambda rows, serve: None)
    monkeypatch.setattr(port, "bench_resume_attach", functools.partial(
        port.bench_resume_attach, prompt_len=64))
    out = tmp_path / "rows.json"
    rc, _, stderr = _main(["--out", str(out), "--device", "cpu"], tparams)
    assert rc == 1
    assert "FATAL: attach mode attached 0 of its 4 resumes" in stderr
    assert not out.exists()


def test_the_resume_part_runs_float32_with_tf32_off(tparams, tmp_path,
                                                     monkeypatch):
    """bf16 weights serve the generation part as they are and the resume
    part as a float32 copy with TF32 off; the caller's tree and TF32
    setting are left as they were."""
    bf16 = tree_cast(tparams, torch.bfloat16)
    seen = {}

    def generation(rows, serve):
        seen["generation"] = serve.cfg.dtype, serve.params["norm"].dtype

    def resume(rows, serve):
        seen["resume"] = (serve.cfg.dtype, serve.params["norm"].dtype,
                          torch.backends.cuda.matmul.allow_tf32)

    monkeypatch.setattr(port, "bench_unary", lambda rows, **kw: None)
    monkeypatch.setattr(port, "bench_generation", generation)
    monkeypatch.setattr(port, "bench_resume_attach", resume)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rc, _, _ = _main(["--out", str(tmp_path / "rows.json"), "--device",
                      "cpu"], bf16)
    assert rc == 0
    assert seen["generation"] == (torch.bfloat16, torch.bfloat16)
    assert seen["resume"] == (torch.float32, torch.float32, False)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert bf16["norm"].dtype == torch.bfloat16


def test_without_a_card_it_raises(tmp_path):
    """No fallback hides the card: without ``--device cpu`` and without
    CUDA the run raises through ``resolve_device``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.main(["--out", str(tmp_path / "rows.json")])


def test_max_seq_tiles_the_decode_kernel():
    """Each part's cache is the JAX tool's rounded up to 256: the decode
    kernel tiles it at its default ``block_k``."""
    assert port.max_seq_for(256, 16) == 512    # JAX's 288
    assert port.max_seq_for(448, 24) == 512    # JAX's 480
    assert port.max_seq_for(32, 8) == 256      # JAX's 48
    assert tl._decode_block(port.max_seq_for(256, 16)) == 256


def test_default_out_is_under_the_ignored_build_directory():
    out = os.path.relpath(port.DEFAULT_OUT, REPO)
    assert out.split(os.sep)[0] == "build"
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()
