"""``chip_smoke.py`` phase 17 (the distributed perf analyzer and the
router-tier bench) rehearsed on the CPU: ``phase_distributed(...,
device="cpu")`` serves a float32 ``tiny`` llama, a narrow ResNet-50 and
the fixtures over the port's HTTP server, runs each arm's single client
process and its coordinator with worker processes, then
``bench_router_tier`` run small, and passes its own checks (the card's
launch checks and the CUDA-region arm are made on the card only); the
kernels line built from its launches carries every key of the contract
for each side."""

import contextlib
import dataclasses
import io
import json
import os

import pytest
import torch

from tpuserver_torch.models import llama as tl
from tpuserver_torch.models import vision as tv

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys every row of the kernels line must carry
CONTRACT = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


class NarrowResNet(tv.ResNet50Model):
    _STAGES = (1, 1, 1, 1)
    _WIDTHS = (32, 64, 128, 256)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    # the CPU's sizes: short prompts and windows, the router tier small
    monkeypatch.setattr(chip_smoke, "DIST_SEQ", 64)
    monkeypatch.setattr(chip_smoke, "DIST_GEN_ARGS", (
        "-m", "llama_generate", "--generation", "--prompt-len", "8",
        "--max-tokens", "8", "--measurement-interval", "500"))
    monkeypatch.setattr(chip_smoke, "DIST_UNARY_ARGS", (
        "-m", "resnet50", "--measurement-interval", "500"))
    # each arm at 4 in flight a side (2 workers of 2), so the rehearsal
    # leaves the other test processes' cores some room
    monkeypatch.setattr(chip_smoke, "DIST_ARMS", tuple(
        (kind, chip_smoke.DIST_GEN_ARGS if kind == "generation"
         else chip_smoke.DIST_UNARY_ARGS, plane, 4, 2, 2)
        for kind, _, plane, _, _, _ in chip_smoke.DIST_ARMS))
    monkeypatch.setattr(chip_smoke, "ROUTER_TIER_ARGV", (
        "--streams", "240", "--control-streams", "60",
        "--takeover-streams", "6", "--workers", "2", "--tokens", "16",
        "--token-delay-ms", "50"))
    monkeypatch.setattr(chip_smoke, "ROUTER_TIER_STREAMS", 240)
    return chip_smoke


def test_phase_distributed_passes_its_checks_on_the_cpu(chip_smoke):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(tl.tiny(vocab=256), dtype=torch.float32)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            launches = chip_smoke.phase_distributed(
                torch, cfg, None, "cpu", device="cpu",
                vision=NarrowResNet(device="cpu", seed=0))
    finally:
        torch.set_num_threads(threads)
    log = out.getvalue()
    assert "FAIL" not in log
    assert "distributed: phase 17" in log
    assert set(launches) == {"distributed_single", "distributed_workers"}
    # the wrappers count no launch on the CPU, where the plain versions run
    assert all(n == 0 for counts in launches.values()
               for n in counts.values())
    # each arm's two sides, and the workers' sum checked window by window
    for label in ("generation", "resnet50", "resnet50 system"):
        for side in ("single", "workers"):
            assert "distributed {} {}: ".format(label, side) in log
        assert "distributed {}: completions by window and worker".format(
            label) in log
    assert "router tier row: " in log

    # the kernels line: two rows a side, each with the contract's keys
    timed = {"ms": 0.02, "plain_ms": 0.2, "bound_ms": 0.001,
             "bound_by": "bytes", "library_ms": 0.03,
             "library_live_ms": 0.02}
    rows = {"timed": {"flash_attention": timed},
            "max_err": {"flash_attention": 0.0, "decode_attention": 0.0}}
    kernels = chip_smoke._distributed_kernel_rows(
        rows, dict(timed, max_abs_err=0.0), launches)
    json.dumps({"kernels": kernels})
    assert {(k["path"], k["name"]) for k in kernels} == {
        (p, n) for p in launches
        for n in ("flash_attention", "decode_attention")}
    for k in kernels:
        assert CONTRACT <= set(k)
