"""``chip_smoke.py`` phase 16 (the serving-plane tools) rehearsed on the
CPU: ``phase_serving_tools(..., device="cpu")`` runs bench_shm_data_plane
and bench_disagg (``--attn kernel`` and ``--attn dense``) on float32
``tiny`` through their ``main``s and passes its own checks (the card's
launch checks are made on the card only); the kernels line built from
its launches carries every key of the contract for each stage."""

import contextlib
import io
import json
import os

import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys every row of the kernels line must carry
CONTRACT = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
STAGES = {"bench_shm_data_plane/generation", "bench_shm_data_plane/resume",
          "bench_disagg_kernel", "bench_disagg_dense"}


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


def test_phase_serving_tools_passes_its_checks_on_the_cpu(chip_smoke,
                                                          two_torch_threads):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launches = chip_smoke.phase_serving_tools(torch, None, "cpu",
                                                  device="cpu")
    log = out.getvalue()
    assert "FAIL" not in log
    assert "serving tools: phase 16" in log
    assert set(launches) == STAGES
    # the wrappers count no launch on the CPU, where the plain versions run
    assert all(n == 0 for counts in launches.values()
               for n in counts.values())
    # each fleet's chunks: none where span prefill is unsafe; at dense, 5
    # for each of the 3 warm-up probes, the identity prompt and 24 probes
    for attn, chunks in (("kernel", 0), ("dense", 28 * 5)):
        head = "tools bench_disagg_{}: rows ".format(attn)
        rows = [line for line in log.splitlines() if line.startswith(head)]
        assert len(rows) == 1
        counted = json.loads(rows[0].split(" rows ", 1)[1])
        assert len(counted) == 4
        assert {c for _, c in counted.values()} == {chunks}

    # the kernels line: two rows a stage, each with the contract's keys, the
    # stage's launches, and the time of the shape it was held at (the card
    # times them; placeholders here)
    timed = {"flash_attention_serving_T{}".format(
        chip_smoke.SERVING_TOOLS_FLASH_T): {}}
    timed.update({"decode_attention_serving_" + part: {}
                  for part in chip_smoke.SERVING_TOOLS_DECODE})
    for row in timed.values():
        row.update(ms=0.02, plain_ms=0.2, bound_ms=0.001, bound_by="bytes",
                   library_ms=0.03, library_live_ms=0.02)
    kernels = chip_smoke._serving_tools_kernel_rows(
        launches, timed, {"flash_attention": 0.0, "decode_attention": 0.0})
    json.dumps({"kernels": kernels})
    assert len(kernels) == 2 * len(STAGES)
    assert {(k["path"], k["name"]) for k in kernels} == {
        (s, n) for s in STAGES
        for n in ("flash_attention", "decode_attention")}
    for row in kernels:
        assert CONTRACT <= set(row), row
        assert row["route"] == "cuda"
        assert row["launches"] == launches[row["path"]][row["name"]]
        assert os.path.exists(os.path.join(REPO, row["source"]))
        path, line = row["replaces"].split(":")
        with open(os.path.join(REPO, path)) as fh:
            assert "pallas_call" in fh.read().splitlines()[int(line) - 1]
    resume = [k for k in kernels if k["path"].endswith("/resume")
              and k["name"] == "decode_attention"]
    assert resume[0]["timed_as"] == "decode_attention_serving_resume"
