"""``chip_smoke.py`` phase 20 (the kernels' whole reference domain)
rehearsed on the CPU: ``phase_kernel_domain(..., device="cpu")`` runs (b)
float32 ``tiny`` served through the port's HTTP server at one slot and at
four against its dense arm, (d) its int8 form against the same decode
step with the plain W8A16 product bound in, and (c) ``tiny`` and the
narrow D 96 multi-query model against their dense arms, and passes its
own checks (the timed routes of (a) and the card's launch checks are made
on the card only; on the CPU every wrapper runs its plain version).  The
checks' rules alone: the top-2-gap rule of the token comparison, a route
that never launched failing the phase, the plain product put back
however its block ends; the kernels line built from the launches
carries every key of the contract.

Tolerances are the phase's own (``KD_LOGITS_TOL``, ``KD_GAP_TOL``,
``KD_INT8_LOGITS_TOL``, ``KD_SMALL_LOGITS_TOL`` in chip_smoke.py)."""

import contextlib
import io
import json
import os

import numpy as np
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
def phase(chip_smoke):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            timed, launches = chip_smoke.phase_kernel_domain(
                torch, np, "cpu", device="cpu")
    finally:
        torch.set_num_threads(threads)
    return {"timed": timed, "launches": launches, "log": out.getvalue()}


def test_phase_kernel_domain_passes_its_checks_on_the_cpu(chip_smoke, phase):
    log = phase["log"]
    assert "FAIL" not in log
    assert "kernel domain: phase 20" in log
    assert phase["timed"] == {}
    assert set(phase["launches"]) == set(chip_smoke.KD_PATHS)
    # the wrappers count no launch on the CPU, where the plain versions run
    for counts in phase["launches"].values():
        assert all(n == 0 for by_route in counts.values()
                   for n in by_route.values())
    assert "prefill last-row logits, kernel arm against dense arm" in log
    assert "(b) one slot: tokens kernel" in log
    assert "(b) 4 slots: tokens kernel" in log
    assert "W8A16 float32 route against the plain product" in log
    for path in ("tiny_kernel", "narrow_d96"):
        assert "kernel domain (c) {}".format(path) in log
    assert "(H 16, Hkv 1, D 96)" in log


def test_the_top2_gap_rule(chip_smoke):
    """Equal tokens pass; a difference passes only where the dense arm's
    top-2 gap at the first differing position is under KD_GAP_TOL of that
    row's largest |logit|, and gap_at is asked for that position."""
    asked = []

    def gap_at(gap, top):
        def at(j):
            asked.append(j)
            return gap, top
        return at

    with contextlib.redirect_stdout(io.StringIO()):
        rec = chip_smoke.kd_token_rule("same", [1, 2, 3], [1, 2, 3],
                                       gap_at(0.0, 1.0))
        assert rec["first_diff"] is None and not asked
        rec = chip_smoke.kd_token_rule("tie", [1, 2, 4, 9], [1, 2, 3, 3],
                                       gap_at(0.0009, 1.0))
        assert asked == [2] and rec["first_diff"] == 2 and rec["near_tie"]
        for gap, top in ((0.001, 1.0), (0.02, 10.0), (5.0, 4.0)):
            with pytest.raises(SystemExit):
                chip_smoke.kd_token_rule("apart", [1, 5], [1, 6],
                                         gap_at(gap, top))
        with pytest.raises(SystemExit):  # a stream that ended short
            chip_smoke.kd_token_rule("short", [1, 2], [1, 2, 3],
                                     gap_at(0.0, 1.0))


def test_a_route_that_never_launched_fails_the_phase(chip_smoke):
    counts = {"flash_attention": {"wgmma": 0, "simt": 32},
              "decode_attention": {"mma": 7, "simt": 0},
              "int8_matmul": {"mma": 0, "simt": 3}}
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.kd_routes_launched("ok", counts, {
            "flash_attention": "simt", "int8_matmul": "simt"})
        with pytest.raises(SystemExit):
            chip_smoke.kd_routes_launched("decode on mma only", counts, {
                "flash_attention": "simt", "decode_attention": "simt"})
        with pytest.raises(SystemExit):
            chip_smoke.kd_routes_launched("no counts", {}, {
                "int8_matmul": "simt"})


def test_the_plain_product_is_put_back(chip_smoke):
    from tpuserver_torch.ops import quant

    kernel = quant.int8_matmul
    with chip_smoke.kd_plain_int8(quant):
        assert quant.int8_matmul is quant.int8_matmul_reference
    assert quant.int8_matmul is kernel
    with pytest.raises(RuntimeError):
        with chip_smoke.kd_plain_int8(quant):
            raise RuntimeError("a step failed")
    assert quant.int8_matmul is kernel

    def fault(x, q, s):
        raise RuntimeError("the planted fault's product")

    with pytest.raises(RuntimeError, match="planted"):
        with chip_smoke.kd_plain_int8(quant, fault):
            quant.int8_matmul(None, None, None)
    assert quant.int8_matmul is kernel


def test_the_kernels_line_rows(chip_smoke, phase):
    """Each path's kernels on their timed route, with the contract's keys
    and the route's launches on the path; every other timed route with
    the 0 launches of a shape no path runs (the card times them;
    placeholders here)."""
    keys = {key for kernels in chip_smoke.KD_PATHS.values()
            for key in kernels.values()} | {"decode_bf16_h128"}
    timed = {}
    for key in keys:
        kname = ("int8_matmul" if key.startswith("int8")
                 else "flash_attention" if key.startswith("flash")
                 else "decode_attention")
        timed[key] = {"kernel": kname, "kernel_route": "simt",
                      "max_abs_err": 0.0, "ms": 0.02, "plain_ms": 0.2,
                      "bound_ms": 0.001, "bound_by": "operations",
                      "library_ms": 0.03}
    timed["decode_bf16_h128"]["kernel_route"] = "mma"
    launches = {path: {k: {"simt": 5} for k in kernels}
                for path, kernels in chip_smoke.KD_PATHS.items()}
    kernels = chip_smoke.kernel_domain_rows(timed, launches)
    json.dumps({"kernels": kernels})
    on_paths = [k for k in kernels if k["path"] != "timed_only"]
    assert {(k["path"], k["name"]) for k in on_paths} == {
        (p, n) for p, ks in chip_smoke.KD_PATHS.items() for n in ks}
    for row in kernels:
        assert CONTRACT <= set(row), row
        assert row["route"] == "cuda"
        assert os.path.exists(os.path.join(REPO, row["source"]))
        path, line = row["replaces"].split(":")
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read().splitlines()[int(line) - 1]
        assert ("pallas_call" in text if row["name"] != "int8_matmul"
                else "astype(x.dtype)" in text)
    for row in on_paths:
        assert row["launches"] == 5 and row["kernel_route"] == "simt"
    idle = [k for k in kernels if k["path"] == "timed_only"]
    assert [(k["timed_as"], k["launches"], k["expected_launches"],
             k["kernel_route"]) for k in idle] == [
        ("decode_bf16_h128", 0, 0, "mma")]


def test_phase3_errors_name_every_route(chip_smoke):
    """The full script's kernels line names every route of each kernel
    with the largest row-relative error phase 3 held it to: each case
    under the route its dtype and head dim take."""
    rows = [
        {"kernel": "flash_attention", "dtype": "bfloat16", "d": 128, "h": 32,
         "hkv": 8, "row_rel_err": 0.004},
        {"kernel": "flash_attention", "dtype": "float32", "d": 128, "h": 8,
         "hkv": 2, "row_rel_err": 2e-6},
        {"kernel": "flash_attention", "dtype": "bfloat16", "d": 8, "h": 8,
         "hkv": 4, "row_rel_err": 0.01},
        {"kernel": "decode_attention", "dtype": "bfloat16", "d": 128,
         "h": 128, "hkv": 8, "row_rel_err": 0.002},
        {"kernel": "decode_attention", "dtype": "bfloat16", "d": 96, "h": 16,
         "hkv": 1, "row_rel_err": 0.0004},
        {"kernel": "decode_attention", "dtype": "float32", "d": 96, "h": 16,
         "hkv": 1, "row_rel_err": 3e-6},
        {"kernel": "int8_matmul", "dtype": "bfloat16", "row_rel_err": 0.007},
        {"kernel": "int8_matmul", "kernel_route": "simt", "dtype": "float32",
         "row_rel_err": 1e-6}]
    assert chip_smoke._route_errors(rows) == {
        "flash_attention": {"wgmma": 0.01, "simt": 2e-6},
        "decode_attention": {"mma": 0.002, "simt": 3e-6},
        "int8_matmul": {"mma": 0.007, "simt": 1e-6}}


# ptxas -v lines of nvcc's log as the card's toolkit writes them (the
# mangled names of the port's kernel instances)
NVCC_LOG = """== decode_attention.cu
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__0fc03474_19_decode_attention_cu_ecef93b327decode_attention_mma_kernelILi128ELi16ELb1EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiiiixxxxxxxxxxf' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__0fc03474_19_decode_attention_cu_ecef93b327decode_attention_mma_kernelILi128ELi16ELb1EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiiiixxxxxxxxxxf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 150 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__0fc03474_19_decode_attention_cu_ecef93b323decode_attention_kernelIfLi8EEEvPKT_S3_S3_PKiPS1_Pfiiiiixxxxxxxxxxf' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__0fc03474_19_decode_attention_cu_ecef93b323decode_attention_kernelIfLi8EEEvPKT_S3_S3_PKiPS1_Pfiiiiixxxxxxxxxxf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
== flash_attention.cu
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__74ca5886_18_flash_attention_cu_feabeab022flash_attention_kernelILi192EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiixxxf' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__74ca5886_18_flash_attention_cu_feabeab022flash_attention_kernelILi192EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiixxxf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 164 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__74ca5886_18_flash_attention_cu_feabeab027flash_attention_simt_kernelILi1EEEvPKfS2_S2_Pfiiiiixxxxxxxxxxxxf' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__74ca5886_18_flash_attention_cu_feabeab027flash_attention_simt_kernelILi1EEEvPKfS2_S2_Pfiiiiixxxxxxxxxxxxf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_numbers_of_a_rows_kernel_instance(chip_smoke):
    """Phase 20 (a) prints beside each route's time the registers and
    spilled bytes ptxas gave the kernel instance the row's shape
    launches: the head dim padded to 64, 128, 192 or 256 on the tensor
    cores, with decode's MMA rows (8 where a group holds at most 8
    heads below D_p 256, else 16) and whether the head dim is D_p itself
    (64 or 128); on flash's float32 route the column groups of P V (1 up
    to D 128, else 2), on decode's the compiled head count."""
    inst = chip_smoke.ptxas_instances(NVCC_LOG)
    assert len(inst) == 4
    ki = chip_smoke.kernel_instance
    assert ki("flash_attention", "wgmma", 136) == \
        "flash_attention_kernelILi192E"
    assert ki("flash_attention", "wgmma", 8) == "flash_attention_kernelILi64E"
    assert ki("flash_attention", "simt", 96) == \
        "flash_attention_simt_kernelILi1E"
    assert ki("flash_attention", "simt", 136) == \
        "flash_attention_simt_kernelILi2E"
    assert ki("decode_attention", "mma", 96, 16) == \
        "decode_attention_mma_kernelILi128ELi16ELb0E"
    assert ki("decode_attention", "mma", 128, 4) == \
        "decode_attention_mma_kernelILi128ELi8ELb1E"
    assert ki("decode_attention", "mma", 256, 4) == \
        "decode_attention_mma_kernelILi256ELi16ELb0E"
    assert ki("decode_attention", "simt", 128, 32) == \
        "decode_attention_kernelIfLi8E"
    assert ki("decode_attention", "simt", 128, 3) == \
        "decode_attention_kernelIfLi4E"
    assert chip_smoke.ptxas_of(inst, ki("flash_attention", "wgmma", 192)) == {
        "instances": 1, "registers": 164, "spill_stores": 0,
        "spill_loads": 0}
    assert chip_smoke.ptxas_of(inst, ki("flash_attention", "simt", 72)) == {
        "instances": 1, "registers": 168, "spill_stores": 0,
        "spill_loads": 0}
    assert chip_smoke.ptxas_of(inst, ki("decode_attention", "simt", 64, 8)) \
        == {"instances": 1, "registers": 255, "spill_stores": 4,
            "spill_loads": 12}
    assert chip_smoke.ptxas_of(inst, ki("decode_attention", "mma", 128,
                                        16)) == {
        "instances": 1, "registers": 150, "spill_stores": 0,
        "spill_loads": 0}
    assert chip_smoke.ptxas_of(inst, ki("decode_attention", "mma", 128)) \
        is None
    # an instance the log does not hold, and the flash wgmma name that is
    # no prefix of the simt one
    assert chip_smoke.ptxas_of(inst, ki("flash_attention", "wgmma", 256)) \
        is None
    assert chip_smoke.ptxas_of(inst, "flash_attention_kernelILi3E") is None
