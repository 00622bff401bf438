"""``python -m tpuserver_torch.bench_prefix_cache`` against the JAX package's
``tools/bench_prefix_cache.py`` on the CPU.

The JAX tool is loaded by path and not edited.  Its warm/cold and
capacity parts run as they are (``tiny`` at vocab 512, JAX's weights)
beside the port's on the port's bf16 ``tiny`` at vocab 512 on the CPU:
the rows' keys and metrics, the warm admissions' hit rate (240 of 256
tokens, exact), the prompt length and the 16 live streams agree.  The
JAX tool's fleet rows and payload keys are read by running its functions
with the fleet and the parts stubbed out (its fleet needs no weights of
the port to show its keys).  The port's fleet part runs at ``tiny`` with
short windows; which arm wins is not held (the JAX tool's own run here
measured 61.7% affinity against 62.8% hash-blind).  A router whose
``/metrics`` view drops one replica's prefix counters is planted and
caught."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from tpuserver_torch import bench_prefix_cache as port
from tpuserver_torch._bench_common import serving
from tpuserver_torch.fleet_router import FleetRouter
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_prefix_cache.py")
# the fleet part's windows, cut for the CPU
SHORT = {"FLEET_WINDOW_S": 0.5, "FLEET_TRIALS": 3, "FLEET_WARMUP_S": 0.2}
# the keys each port fleet row adds to the JAX tool's
ADDED = {"prefix_cache_hits", "prefix_cache_misses"}


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("jax_bench_prefix_cache",
                                                  TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_rows(tool):
    rows = []
    with contextlib.redirect_stdout(io.StringIO()):
        tool.bench_warm_vs_cold_prefill(rows)
        tool.bench_capacity_beyond_slots(rows)
    return rows


@pytest.fixture(scope="module")
def serve():
    return serving("tiny", "cpu", None, vocab=512, dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def port_rows(serve):
    rows = []
    with contextlib.redirect_stdout(io.StringIO()):
        port.bench_warm_vs_cold_prefill(rows, serve)
        port.bench_capacity_beyond_slots(rows, serve)
    return rows


@pytest.fixture
def short_windows(monkeypatch):
    for name, value in SHORT.items():
        monkeypatch.setattr(port, name, value)


def test_rows_have_the_jax_keys_and_metrics(jax_rows, port_rows):
    assert [r["metric"] for r in port_rows] == [r["metric"] for r in jax_rows]
    for mine, theirs in zip(port_rows, jax_rows):
        assert set(mine) == set(theirs), mine["metric"]
        for key in ("config", "unit", "vs_baseline", "prompt_tokens",
                    "old_max_slots_bound", "kv_pages", "page_size"):
            assert mine.get(key) == theirs.get(key), (mine["metric"], key)


def test_warm_hit_rate_equals_jax(jax_rows, port_rows):
    """240 of the warm prompt's 256 tokens come from the radix cache on
    both sides: 93.8%, exact."""
    def warm(rows):
        return next(r for r in rows
                    if r["metric"] == "prefill_ttft_warm_256tok")

    assert warm(port_rows)["radix_hit_rate_pct"] == \
        warm(jax_rows)["radix_hit_rate_pct"] == 93.8
    assert warm(port_rows)["prompt_tokens"] == 256
    for row in port_rows[:2]:
        assert np.isfinite(row["value"]) and row["value"] > 0


def test_capacity_streams_equal_jax(jax_rows, port_rows):
    """16 streams live at once over a pool of four full-length slots."""
    def live(rows):
        return next(r for r in rows
                    if r["metric"] == "concurrent_streams_equal_memory")

    assert live(port_rows)["value"] == live(jax_rows)["value"] == 16


def test_fleet_rows_have_the_jax_keys_and_a_measured_rate(tool, serve,
                                                           short_windows,
                                                           monkeypatch):
    """Both arms' rows, each with the JAX tool's keys, a hit rate the
    profiler measured in [0, 100], and the counters it came from."""
    jax_fleet = []
    monkeypatch.setattr(tool, "_fleet_hit_rate", lambda affinity_bonus: {
        "prefix_hit_pct": 50.0, "throughput": 1.0, "ttft_p50_ms": 1.0})
    with contextlib.redirect_stdout(io.StringIO()):
        tool.bench_affinity_vs_blind(jax_fleet)
    rows = []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port.bench_affinity_vs_blind(rows, serve)
    assert [r["metric"] for r in rows] == [r["metric"] for r in jax_fleet] \
        == ["hit_rate_affinity", "hit_rate_hash_blind"]
    for mine, theirs in zip(rows, jax_fleet):
        assert set(mine) == set(theirs) | ADDED
        assert 0.0 <= mine["value"] <= 100.0
        assert mine["prefix_cache_hits"] + mine["prefix_cache_misses"] > 0
        assert mine["value"] == round(100.0 * mine["prefix_cache_hits"] / (
            mine["prefix_cache_hits"] + mine["prefix_cache_misses"]), 1)
        assert mine["tokens_per_sec"] > 0
    assert "fleet prefix-cache hit rate: affinity" in out.getvalue()


def test_a_fleet_view_that_drops_a_replica_is_caught(serve, short_windows,
                                                     monkeypatch):
    """The router's ``/metrics`` loses one replica's prefix counters (a
    planted fault in the aggregation's input): the fleet counters no
    longer equal the replicas' sum, and the part fails instead of writing
    the wrong rate."""
    fetch = FleetRouter._fetch_metrics
    kept = []

    def dropping(self, rep):
        text = fetch(self, rep)
        if not kept:
            kept.append(rep.url)
        if text is None or rep.url == kept[0]:
            return text
        return "\n".join(line for line in text.splitlines()
                         if "tpu_prefix_cache_" not in line) + "\n"

    monkeypatch.setattr(FleetRouter, "_fetch_metrics", dropping)
    with contextlib.redirect_stdout(io.StringIO()):
        res = port._fleet_hit_rate(2.0, serve)
    assert res["fleet_counters"] != res["replica_counters"]
    assert res["fleet_counters"]["misses"] < \
        res["replica_counters"]["misses"]
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(port.CheckFailed, match="replicas' sum"):
        port.bench_affinity_vs_blind([], serve)


def test_main_writes_the_jax_payload(tool, serve, tmp_path, monkeypatch):
    """``main(["--skip-fleet", ...])`` exits 0 and writes the JAX tool's
    payload keys, the warm, capacity and headline rows, and a ``cmd`` and
    ``note`` naming the port's run."""
    jax_out = tmp_path / "jax.json"
    for name in ("bench_warm_vs_cold_prefill", "bench_capacity_beyond_slots",
                 "bench_affinity_vs_blind", "bench_simple_headline"):
        monkeypatch.setattr(tool, name, lambda rows: None)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tool.main(["--out", str(jax_out), "--skip-fleet"]) == 0
    with open(jax_out) as fh:
        want = json.load(fh)

    out = tmp_path / "port.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = port.main(["--skip-fleet", "--out", str(out), "--device",
                        "cpu"], params=serve.params)
    assert rc == 0
    with open(out) as fh:
        payload = json.load(fh)
    assert set(payload) == set(want)
    assert payload["n"] == want["n"] and payload["rc"] == 0
    assert payload["cmd"].startswith(
        "python -m tpuserver_torch.bench_prefix_cache --skip-fleet")
    assert "llama tiny" in payload["note"] and "on cpu" in payload["note"]
    metrics = [r["metric"] for r in payload["rows"]]
    assert metrics == ["prefill_ttft_cold_256tok", "prefill_ttft_warm_256tok",
                       "concurrent_streams_equal_memory",
                       "simple_inprocess_headline"]
    head = payload["rows"][-1]
    assert head["value"] > 0 and head["p50_usec"] > 0


def test_attn_kernel_exits_2_naming_dense(capsys):
    """At ``--attn kernel`` the scheduler keeps the radix cache off: the
    run exits 2 before it draws a weight, and names ``--attn dense``."""
    assert port.main(["--attn", "kernel", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--attn dense" in err and "span_safe" in err


def test_without_a_card_and_without_cpu_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.main(["--skip-fleet"])
