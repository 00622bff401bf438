"""``chip_smoke.py`` phase 19 (the perf analyzer's fleet-router view)
rehearsed on the CPU: ``phase_router_view(..., device="cpu")`` runs (a)
two port servers on float32 ``tiny`` behind the port's ``FleetRouter``
with a plain and a sever arm of ``python -m tpuserver_torch.perf_analyzer``
processes, and (b) a supervised fleet of two ``serve.py --models fixtures``
processes with one SIGKILL, and passes its own checks (the card's launch
checks are made on the card only).  The checks fail on a planted error,
missing router keys or footer, a sever arm the router absorbed nothing
of, a wrong flash count, no decode launch, and a handed-off stream whose
tokens before its handoff differ; the kernels line built from the
launches carries every key of the contract."""

import contextlib
import dataclasses
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


@pytest.fixture(scope="module")
def chip_smoke():
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(REPO)
    import chip_smoke

    yield chip_smoke
    mp.undo()


@pytest.fixture(scope="module")
def cfg():
    from tpuserver_torch.models import llama as tl

    return dataclasses.replace(tl.tiny(vocab=512), dtype=torch.float32)


@pytest.fixture(scope="module")
def phase(chip_smoke, cfg):
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    params = LlamaGenerateModel(cfg=cfg, seed=0,
                                device="cpu")._ensure_params()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            launches = chip_smoke.phase_router_view(torch, cfg, params, "cpu",
                                                    device="cpu")
    finally:
        torch.set_num_threads(threads)
    return {"launches": launches, "log": out.getvalue()}


def test_phase_router_view_passes_its_checks_on_the_cpu(phase):
    log = phase["log"]
    assert "FAIL" not in log
    assert "router view: phase 19" in log
    assert set(phase["launches"]) == {"plain", "sever"}
    # the wrappers count no launch on the CPU, where the plain versions run
    assert all(n == 0 for counts in phase["launches"].values()
               for n in counts.values())
    for arm in ("plain", "sever"):
        assert re.search(r"router view {}: .* 0 errors".format(arm), log)
    absorbed = re.search(r"router view sever: .*the router absorbed "
                         r"(\{[^}]*\})", log)
    absorbed = json.loads(absorbed.group(1))
    assert absorbed["handoffs"] + absorbed["failovers"] > 0
    assert "handed-off streams" in log
    fleet = re.search(r"router view \(b\): perf_analyzer exit 0; .*replica "
                      r"restarts (\d+) .*children left \[\]", log)
    assert fleet and int(fleet.group(1)) >= 1
    assert "supervisor restarts=" in log


def _row():
    return {"errors": 0, "tokens": 64, "router_failovers": 0,
            "router_handoffs": 2, "router_resumed_streams": 0,
            "router_shed": 0}


@pytest.mark.parametrize("plant", [
    "errors", "no_tokens", "router_key", "negative", "footer", "absorbed",
    "flash", "no_512", "no_decode", "admissions"])
def test_the_checks_fail_on_a_plant(chip_smoke, cfg, plant):
    """The unplanted arm passes; each plant fails it."""
    footer = "  level 4: router failovers=0 handoffs=2 resumed_streams=0"
    absorbed = {"handoffs": 2, "failovers": 0}
    lengths = [512, 512, 520]
    launches = {"flash_attention": 2 * cfg.n_layers, "decode_attention": 40}
    args = ["sever", _row(), footer, absorbed, cfg, launches, lengths, 3]
    chip_smoke._router_view_checks(*args)
    if plant == "errors":
        args[1]["errors"] = 1
    elif plant == "no_tokens":
        args[1]["tokens"] = 0
    elif plant == "router_key":
        del args[1]["router_shed"]
    elif plant == "negative":
        args[1]["router_handoffs"] = -1
    elif plant == "footer":
        args[2] = "no footer"
    elif plant == "absorbed":
        args[3] = {"handoffs": 0, "failovers": 0}
    elif plant == "flash":
        args[5] = dict(launches, flash_attention=3 * cfg.n_layers)
    elif plant == "no_512":
        args[6] = [520, 528, 536]
        args[5] = dict(launches, flash_attention=0)
    elif plant == "no_decode":
        args[5] = dict(launches, decode_attention=0)
    else:
        args[7] = 4
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            pytest.raises(SystemExit):
        chip_smoke._router_view_checks(*args)
    assert "FAIL: router view" in out.getvalue()


def test_the_agreement_check(chip_smoke):
    """A token after the first handoff may differ (reported); one before
    it fails."""
    prompt = (1, 2, 3)
    plain = {prompt: [5, 6, 7, 8]}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = chip_smoke._router_view_agreement(
            [(prompt, [5, 6, 7, 9], 2), (prompt, [5, 6, 7, 8], 0)], plain)
    assert got == (5, 6)
    assert "after it 5/6 agree" in out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            pytest.raises(SystemExit):
        chip_smoke._router_view_agreement([(prompt, [5, 9, 7, 8], 2)], plain)
    assert "before its first handoff" in out.getvalue()


def test_the_kernels_line_rows(chip_smoke, phase):
    """A flash and a decode row on the ``router_view`` path, with the
    contract's keys and both arms' launches summed (the card times them;
    placeholders here)."""
    timed = {"ms": 0.012, "plain_ms": 0.2, "bound_ms": 0.0003,
             "bound_by": "bytes", "library_ms": 0.02, "library_live_ms": 0.02}
    rows = {"max_err": {"flash_attention": 0.0, "decode_attention": 0.0},
            "timed": {"flash_attention": timed}}
    launches = {"plain": {"flash_attention": 64, "decode_attention": 900},
                "sever": {"flash_attention": 96, "decode_attention": 1100}}
    kernels = chip_smoke._router_view_kernel_rows(
        rows, dict(timed, max_abs_err=0.001), launches)
    json.dumps({"kernels": kernels})
    assert [(k["name"], k["path"], k["launches"]) for k in kernels] == [
        ("flash_attention", "router_view", 160),
        ("decode_attention", "router_view", 2000)]
    for row in kernels:
        assert CONTRACT <= set(row), row
        assert row["route"] == "cuda"
        assert os.path.exists(os.path.join(REPO, row["source"]))
        path, line = row["replaces"].split(":")
        with open(os.path.join(REPO, path)) as fh:
            assert "pallas_call" in fh.read().splitlines()[int(line) - 1]
    assert kernels[1]["max_abs_err"] == 0.001
    assert "544" in kernels[1]["timed_as"]
