"""``chip_smoke.py`` phase 15 (the model-path tuning tools) rehearsed on
the CPU: ``phase_tools(..., device="cpu")`` runs bench_kernels' sweep at
small shapes (its module's constants made small here), the prefill sweep
on ``tiny`` and bench_speculative on float32 ``tiny`` at vocab 512
through their ``main``s and passes its own checks (the card's launch
counts, shares of the peak and timing checks are made on the card
only)."""

import contextlib
import dataclasses
import io
import os

import pytest
import torch

from tpuserver_torch import bench_kernels
from tpuserver_torch.models import llama

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench_kernels' sweep at CPU size: flash at T 128, decode at half of a
# 256-key cache, heads 2 (one kv head), d 64; chains 64 calls apart, so
# that the difference stands above a loaded CPU's timing noise (the
# phase holds every time finite and positive)
SMALL_SWEEP = {"FLASH_LENS": {128: (2, 66)}, "DECODE_CASES": ((256, 0.5),),
               "DECODE_LENS": (2, 66), "HEADS": 2, "KV_HEADS": 1,
               "HEAD_DIM": 64}


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    return chip_smoke


@pytest.fixture
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_phase_tools_passes_its_checks_on_the_cpu(chip_smoke, monkeypatch,
                                                  two_torch_threads):
    for name, value in SMALL_SWEEP.items():
        monkeypatch.setattr(bench_kernels, name, value)
    cfg = dataclasses.replace(llama.tiny(vocab=512), dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launches = chip_smoke.phase_tools(torch, params, "cpu",
                                          device="cpu")
    log = out.getvalue()
    assert "FAIL" not in log
    assert "tools: phase 15" in log
    assert set(launches) == {"bench_kernels", "prefill_sweep",
                             "bench_speculative"}
    # the wrappers count no launch on the CPU, where the plain versions
    # run, and no graph is captured or replayed
    assert launches["bench_kernels"].pop("graph_replayed") == {
        "flash_attention": 0, "decode_attention": 0}
    assert all(n == 0 for counts in launches.values()
               for n in counts.values())
    rows = [line for line in log.splitlines()
            if line.startswith("tools prefill_sweep: {")]
    assert len(rows) == 22
    kernel_rows = [line for line in log.splitlines()
                   if line.startswith("tools bench_kernels: {")]
    # dense and kernel rows and the speedup line, for flash and decode
    assert len(kernel_rows) == 6
