"""``chip_smoke.py`` phase 18 (the prefix-cache bench and the server-side
demos) rehearsed on the CPU: ``phase_prefix_cache(..., device="cpu")``
runs ``bench_prefix_cache`` on float32 ``tiny`` through its ``main`` (the
fleet part's windows cut), the router demo in-process, the fleet demo as
a process and the HTTP CUDA-region client over CPU regions, and passes
its own checks (the card's launch checks are made on the card only).  The
phase's checks fail on a planted wrong hit rate, a short stream count, an
unmeasured fleet rate and a missing decode launch; the kernels line built
from its launches carries every key of the contract for each path."""

import contextlib
import copy
import io
import json
import os
import re

import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
SHORT = {"FLEET_WINDOW_S": 0.5, "FLEET_TRIALS": 3, "FLEET_WARMUP_S": 0.2}


@pytest.fixture(scope="module")
def chip_smoke():
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(REPO)
    import chip_smoke

    yield chip_smoke
    mp.undo()


@pytest.fixture(scope="module")
def phase(chip_smoke):
    from tpuserver_torch import bench_prefix_cache

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    for name, value in SHORT.items():
        mp.setattr(bench_prefix_cache, name, value)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            launches = chip_smoke.phase_prefix_cache(torch, "cpu",
                                                     device="cpu")
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    log = out.getvalue()
    rows = [json.loads(line.split("prefix cache row: ", 1)[1])
            for line in log.splitlines()
            if line.startswith("prefix cache row: ")]
    return {"launches": launches, "log": log, "rows": rows}


def test_phase_prefix_cache_passes_its_checks_on_the_cpu(chip_smoke, phase):
    log = phase["log"]
    assert "FAIL" not in log
    assert "prefix cache: phase 18" in log
    assert set(phase["launches"]) == set(
        chip_smoke.PREFIX_PARTS.values()) | {"router_demo"}
    # the wrappers count no launch on the CPU, where the plain versions run
    assert all(n == 0 for counts in phase["launches"].values()
               for n in counts.values())
    assert [r["metric"] for r in phase["rows"]] == [
        "prefill_ttft_cold_256tok", "prefill_ttft_warm_256tok",
        "concurrent_streams_equal_memory", "hit_rate_affinity",
        "hit_rate_hash_blind", "simple_inprocess_headline"]
    assert re.search(r"router demo: [1-9]\d* handoffs", log)
    assert "healed: restarts=1 up=2" in log
    assert "HTTP CUDA-region client: 32 output lines, regions left ({}, {}, " \
        "[])" in log


def _launches(chip_smoke, decode=100, flash=0):
    return {part: {"flash_attention": flash, "decode_attention": decode}
            for part in chip_smoke.PREFIX_PARTS}


@pytest.mark.parametrize("plant", ["hit_rate", "streams", "fleet_unmeasured",
                                   "fleet_missing", "headline_missing"])
def test_the_checks_fail_on_planted_rows(chip_smoke, phase, plant):
    rows = copy.deepcopy(phase["rows"])
    by = {r["metric"]: r for r in rows}
    if plant == "hit_rate":
        by["prefill_ttft_warm_256tok"]["radix_hit_rate_pct"] = 90.6
    elif plant == "streams":
        by["concurrent_streams_equal_memory"]["value"] = 15
    elif plant == "fleet_unmeasured":
        by["hit_rate_hash_blind"].update(prefix_cache_hits=0,
                                         prefix_cache_misses=0)
    elif plant == "fleet_missing":
        rows.remove(by["hit_rate_affinity"])
    else:
        rows.remove(by["simple_inprocess_headline"])
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            pytest.raises(SystemExit):
        chip_smoke._prefix_bench_checks(rows, _launches(chip_smoke), True)
    assert "FAIL: prefix cache" in out.getvalue()


@pytest.mark.parametrize("plant", ["no_decode", "flash"])
def test_the_checks_fail_on_a_planted_launch_count(chip_smoke, phase, plant):
    """A llama part without a decode launch, or with a flash one (the
    bench prefills dense), fails on the card; the unplanted counts pass."""
    chip_smoke._prefix_bench_checks(phase["rows"], _launches(chip_smoke),
                                    True)
    by_part = _launches(chip_smoke)
    part = "bench_capacity_beyond_slots"
    by_part[part] = ({"flash_attention": 0, "decode_attention": 0}
                     if plant == "no_decode"
                     else {"flash_attention": 32, "decode_attention": 100})
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            pytest.raises(SystemExit):
        chip_smoke._prefix_bench_checks(phase["rows"], by_part, True)
    assert part in out.getvalue()


def test_the_kernels_line_rows(chip_smoke, phase):
    """One decode row a path, with the contract's keys, the path's
    launches and the time of the shape it was held at (the card times
    them; placeholders here)."""
    timed = {path: {"ms": 0.012, "plain_ms": 0.2, "bound_ms": 0.0003,
                    "bound_by": "bytes", "library_ms": 0.02,
                    "library_live_ms": 0.02}
             for path in chip_smoke.PREFIX_DECODE}
    kernels = chip_smoke._prefix_cache_kernel_rows(phase["launches"], timed,
                                                   0.0)
    json.dumps({"kernels": kernels})
    assert {k["path"] for k in kernels} == set(chip_smoke.PREFIX_DECODE)
    for row in kernels:
        assert CONTRACT <= set(row), row
        assert row["name"] == "decode_attention" and row["route"] == "cuda"
        assert row["launches"] == \
            phase["launches"][row["path"]]["decode_attention"]
        assert os.path.exists(os.path.join(REPO, row["source"]))
        path, line = row["replaces"].split(":")
        with open(os.path.join(REPO, path)) as fh:
            assert "pallas_call" in fh.read().splitlines()[int(line) - 1]
    demo = [k for k in kernels if k["path"] == "router_demo"][0]
    assert demo["timed_as"].endswith("float32")
