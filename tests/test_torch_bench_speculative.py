"""``python -m tpuserver_torch.bench_speculative`` against the JAX
package's ``tools/bench_speculative.py`` on the CPU.

Both run float32 ``tiny`` at vocab 512 on the same weights (JAX's
``init_params(PRNGKey(0))``, bridged to the port).  The JAX tool is
loaded by path and not edited; its ``_build`` draws ``llama.tiny``, which
a fixture turns float32 for the run.  Every ``_run`` of both tools is
recorded with the scheduler's counters around it: the agentic
regenerate's tokens and speculative counters must equal JAX's exactly
(one stream, deterministic), the repetitive streams must equal JAX's
plain reference."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserver
from tpuserver.models import llama as jl
from tpuserver_torch import bench_speculative as port
from tpuserver_torch.models import llama as tl
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_speculative.py")
SPEC_KEYS = ("spec_steps", "spec_proposed", "spec_accepted",
             "spec_rollbacks")


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


def _recorder(module, log):
    """``module._run`` wrapped: each call appends (prompt, n, tokens, the
    scheduler's speculative counters moved by the call)."""
    real = module._run

    def run(sched, prompt, n):
        before = sched.stats()
        toks, dt = real(sched, prompt, n)
        after = sched.stats()
        log.append((list(prompt), n, list(toks),
                    {k: after[k] - before[k] for k in SPEC_KEYS}))
        return toks, dt

    return run


@pytest.fixture(scope="module")
def jax_tool():
    tool = _load_jax_tool(TOOL, "jax_bench_speculative")
    real_tiny = jl.tiny
    mp = pytest.MonkeyPatch()
    mp.setattr(jl, "tiny", lambda vocab=256: dataclasses.replace(
        real_tiny(vocab), dtype=jnp.float32))
    yield tool
    mp.undo()


@pytest.fixture(scope="module")
def serve():
    cfg = dataclasses.replace(jl.tiny(vocab=512), dtype=jnp.float32)
    params = tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg)), "cpu")
    assert params["norm"].dtype == torch.float32
    return port.serving("tiny", "cpu", params)


@pytest.fixture(scope="module")
def jax_agentic(jax_tool):
    log, rows = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tool, "_run", _recorder(jax_tool, log))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jax_tool.bench_agentic_regenerate(rows)
    finally:
        mp.undo()
    return log, rows


@pytest.fixture(scope="module")
def port_main(serve, tmp_path_factory):
    """The port's ``main`` once, every ``_run`` and concurrent round
    recorded, its rows read back from ``--out``."""
    log, rounds = [], []
    real_concurrent = port._run_concurrent

    def concurrent(sched, prompt, n, streams):
        outs, dt = real_concurrent(sched, prompt, n, streams)
        rounds.append((list(prompt), n, outs))
        return outs, dt

    out = tmp_path_factory.mktemp("spec") / "rows.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(port, "_run", _recorder(port, log))
    mp.setattr(port, "_run_concurrent", concurrent)
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            rc = port.main(["--out", str(out), "--device", "cpu"],
                           params=serve.params)
    finally:
        mp.undo()
    with open(out) as fh:
        payload = json.load(fh)
    return {"rc": rc, "log": log, "rounds": rounds, "payload": payload,
            "stdout": stdout.getvalue()}


def _jax_row_keys():
    """The key set of each row literal the JAX tool appends, by metric."""
    with open(TOOL) as fh:
        tree = ast.parse(fh.read())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            fields = {k.value: v for k, v in zip(node.keys, node.values)}
            keys[fields["metric"].value] = {k.value for k in node.keys}
    return keys


def test_agentic_regenerate_equals_jax_exactly(jax_agentic, port_main):
    """The port's regenerate runs (warm-ups, turn 1, turn 2 on each
    scheduler) give JAX's tokens and move the speculative counters by
    JAX's amounts, run for run; the row's accept/step and hit rate are
    JAX's."""
    jax_log, jax_rows = jax_agentic
    agentic = [r for r in port_main["log"] if r[0] in (
        port.AGENTIC, [21, 23] * 8)]
    assert len(jax_log) == 6 and len(agentic) == 6
    for mine, theirs in zip(agentic, jax_log):
        assert mine[:3] == theirs[:3]
        assert mine[3] == theirs[3]
    # turn 2 on the speculating scheduler drafted and was accepted
    turn2 = jax_log[-1][3]
    assert turn2["spec_steps"] > 0 and turn2["spec_accepted"] > 0
    row = next(r for r in port_main["payload"]["rows"]
               if r["metric"] == "accept_per_step_regenerate")
    assert row["value"] == jax_rows[0]["value"]
    assert row["draft_hit_pct"] == jax_rows[0]["draft_hit_pct"]


def test_repetitive_streams_equal_jax_reference(jax_tool, port_main):
    """Every repetitive stream of the port (the first service on both
    schedulers and the 48 concurrent ones) is the JAX tool's plain
    reference; accept/step is above 3 (concurrent admission order varies
    from run to run)."""
    plain = jax_tool._build(0, slots=8)
    try:
        ref, _ = jax_tool._run(plain, jax_tool.REPETITIVE, 52)
    finally:
        plain.close()
    assert len(ref) == 52
    first = [r[2] for r in port_main["log"] if r[0] == port.REPETITIVE]
    assert first == [ref, ref]
    assert len(port_main["rounds"]) == 6
    for prompt, n, outs in port_main["rounds"]:
        assert prompt == port.REPETITIVE and n == 52
        assert outs == [ref] * 8
    row = next(r for r in port_main["payload"]["rows"]
               if r["metric"] == "accept_per_step_repetitive")
    assert row["value"] > 3.0


def test_main_writes_five_rows_with_the_jax_keys(port_main):
    payload = port_main["payload"]
    assert port_main["rc"] == 0
    want = _jax_row_keys()
    assert [r["metric"] for r in payload["rows"]] == list(want)
    for row in payload["rows"]:
        assert set(row) == want[row["metric"]], row["metric"]
    column = next(r for r in payload["rows"]
                  if r["metric"] == "perfanalyzer_accept_per_step")
    assert column["value"] > 1.0
    assert "tiny (2 layers) in float32 on cpu" in payload["note"]
    assert "TPU" not in payload["note"]
    assert "wrote 5 rows" in port_main["stdout"]


def test_default_out_is_under_the_ignored_build_directory():
    out = os.path.relpath(port.DEFAULT_OUT, REPO)
    assert out.split(os.sep)[0] == "build"
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()
    assert not out.startswith("BENCH_r")
