"""``python -m tpuserver_torch.bench_disagg`` against the JAX package's
``tools/bench_disagg.py`` on the CPU.

Both run float32 ``tiny`` at vocab 512 on the same weights (JAX's
``init_params(PRNGKey(0))``, bridged to the port), with ``N_PROBES`` 3
and ``BG_MAX_TOKENS`` 8 set on both modules.  The JAX tool is loaded by
path and not edited; its replicas draw ``llama.tiny``, which a fixture
turns float32.  Each tool's ``run_fleet`` is wrapped to keep what it
returned, so the identity tokens and the routers' split counts of both
fleets are compared; a planted divergence replays the port's recorded
fleets with one of them altered."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import socket
import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.models import llama as jl
from tpuserver_torch import bench_disagg as port
from tpuserver_torch.fleet_router import FleetRouter
from tpuserver_torch.models import llama as tl
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_disagg.py")
SMALL = {"N_PROBES": 3, "BG_MAX_TOKENS": 8}
# the keys each port row adds to the JAX tool's
ADDED = {"attn_impl", "prefill_chunks"}


def _recorded(module, mp, runs):
    """``module.run_fleet`` wrapped: each call's result kept in ``runs``
    by mode."""
    real = module.run_fleet

    def run_fleet(split, **kwargs):
        res = real(split=split, **kwargs)
        runs["split" if split else "fused"] = res
        return res

    mp.setattr(module, "run_fleet", run_fleet)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("jax_bench_disagg", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    real_tiny = jl.tiny
    runs = {}
    out = tmp_path_factory.mktemp("jax_disagg") / "rows.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(jl, "tiny", lambda vocab=256: dataclasses.replace(
        real_tiny(vocab), dtype=jnp.float32))
    for name, value in SMALL.items():
        mp.setattr(tool, name, value)
    _recorded(tool, mp, runs)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tool.main(["--out", str(out)])
    finally:
        mp.undo()
    with open(out) as fh:
        return {"rc": rc, "runs": runs, "rows": json.load(fh)["rows"]}


@pytest.fixture(scope="module")
def tparams():
    cfg = dataclasses.replace(jl.tiny(vocab=512), dtype=jnp.float32)
    params = tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg)), "cpu")
    assert params["norm"].dtype == torch.float32
    return params


def _main(argv, params):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port.main(argv, params=params)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def port_run(tparams, tmp_path_factory):
    runs = {}
    out = tmp_path_factory.mktemp("disagg") / "rows.json"
    mp = pytest.MonkeyPatch()
    for name, value in SMALL.items():
        mp.setattr(port, name, value)
    _recorded(port, mp, runs)
    try:
        rc, stdout, stderr = _main(["--out", str(out), "--device", "cpu"],
                                   tparams)
    finally:
        mp.undo()
    with open(out) as fh:
        payload = json.load(fh)
    return {"rc": rc, "runs": runs, "payload": payload, "stdout": stdout,
            "stderr": stderr}


def test_identity_tokens_equal_jax_in_both_fleets(jax_run, port_run):
    """The pinned prompt's 8 greedy tokens through the fused and the split
    fleet are JAX's (the export, import and rebase seam loses nothing)."""
    want = jax_run["runs"]["fused"]["identity_tokens"]
    assert len(want) == 8
    assert jax_run["runs"]["split"]["identity_tokens"] == want
    for mode in ("fused", "split"):
        assert port_run["runs"][mode]["identity_tokens"] == want, mode


def test_split_fleet_splits_every_probe_and_fused_none(port_run):
    """Every admission of the split fleet took the phase split (the six
    warm-ups, the identity stream, the probes and the background
    streams), none of the fused fleet's;
    both ran chunked prefills (``tiny`` attends densely), 5 chunks of 32
    for each 160-token prompt."""
    split = port_run["runs"]["split"]["disagg"]
    fused = port_run["runs"]["fused"]["disagg"]
    assert split["splits"] >= SMALL["N_PROBES"]
    assert split["splits"] >= 3 + 3 + 1 + SMALL["N_PROBES"]
    assert split["transfers"] >= 3 + 3 + 1 + SMALL["N_PROBES"]
    assert fused["splits"] == 0 and fused["transfers"] == 0
    assert split["prefill_replicas"] == split["decode_replicas"] == 1
    # 3 warm-up probes, the identity prompt and 3 probes, 5 chunks each
    for mode in ("fused", "split"):
        assert port_run["runs"][mode]["prefill_chunks"] == 7 * 5, mode


def test_rows_have_the_jax_keys(jax_run, port_run):
    """Four rows, the JAX tool's metrics in its order, each with its keys
    and ``attn_impl`` and ``prefill_chunks``; exit 0 on both sides."""
    assert jax_run["rc"] == 0 and port_run["rc"] == 0
    got = port_run["payload"]["rows"]
    want = jax_run["rows"]
    assert [r["metric"] for r in got] == [r["metric"] for r in want]
    for mine, theirs in zip(got, want):
        assert set(mine) == set(theirs) | ADDED, mine["metric"]
        for key in ("config", "unit", "prompt_tokens", "prefill_chunk_tokens",
                    "bg_streams", "bg_max_tokens", "probes", "replicas",
                    "token_identical"):
            assert mine.get(key) == theirs.get(key), (mine["metric"], key)
        assert mine["attn_impl"] == "dense" and mine["prefill_chunks"] == 35
        assert mine["value"] > 0
    assert "wrote 4 rows" in port_run["stdout"]
    assert "tiny (2 layers) in float32 on cpu, attn_impl dense" in \
        port_run["payload"]["note"]


def test_kernel_attention_runs_no_chunk(tparams, tmp_path, monkeypatch):
    """``--attn kernel``: the scheduler's ``span_safe`` rule drops the
    chunk size, so the replicas prefill whole and count no chunk; the
    checks hold."""
    for name, value in SMALL.items():
        monkeypatch.setattr(port, name, value)
    out = tmp_path / "rows.json"
    rc, stdout, _ = _main(["--out", str(out), "--device", "cpu", "--attn",
                           "kernel"], tparams)
    assert rc == 0
    with open(out) as fh:
        rows = json.load(fh)["rows"]
    assert {r["attn_impl"] for r in rows} == {"kernel"}
    assert {r["prefill_chunks"] for r in rows} == {0}
    assert "prefill chunks run: fused 0, split 0" in stdout


@pytest.mark.parametrize("fault", ["identity", "unsplit", "fused_split"])
def test_planted_fault_exits_one(fault, port_run, tparams, tmp_path,
                                 monkeypatch):
    """Each of the three checks, fed the port's recorded fleets with one
    thing changed, prints FATAL and exits 1, writing nothing."""
    runs = {mode: dict(res, disagg=dict(res["disagg"]))
            for mode, res in port_run["runs"].items()}
    if fault == "identity":
        tokens = list(runs["split"]["identity_tokens"])
        tokens[-1] = (tokens[-1] + 1) % 512
        runs["split"]["identity_tokens"] = tokens
    elif fault == "unsplit":
        runs["split"]["disagg"]["splits"] = SMALL["N_PROBES"] - 1
    else:
        runs["fused"]["disagg"]["splits"] = 1
    monkeypatch.setattr(port, "N_PROBES", SMALL["N_PROBES"])
    monkeypatch.setattr(port, "run_fleet", lambda split, serve: runs[
        "split" if split else "fused"])
    out = tmp_path / "rows.json"
    rc, _, stderr = _main(["--out", str(out), "--device", "cpu"], tparams)
    assert rc == 1
    assert stderr.startswith("FATAL: ")
    assert not out.exists()


def test_without_a_card_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.main(["--out", str(tmp_path / "rows.json")])


def test_default_out_is_under_the_ignored_build_directory():
    out = os.path.relpath(port.DEFAULT_OUT, REPO)
    assert out.split(os.sep)[0] == "build"
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()


def test_router_ends_a_reset_connection_quietly(capsys):
    """A client that closes with its connection reset (the last chunk of
    a stream left unread) between two requests ends the router's request
    loop without a traceback."""
    router = FleetRouter(["127.0.0.1:1"], probe_interval_s=10.0).start()
    try:
        host, port = router.url.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))
        sock.sendall(b"GET /v2/health/live HTTP/1.1\r\nHost: x\r\n\r\n")
        assert sock.recv(4096).startswith(b"HTTP/1.1 ")
        # linger 0: close() sends a reset while the handler waits for the
        # next request line
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
        time.sleep(0.3)
    finally:
        router.stop()
    err = capsys.readouterr().err
    assert "ConnectionResetError" not in err
    assert "Exception occurred during processing" not in err
