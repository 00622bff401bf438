"""The port's CUDA kernels held against their plain PyTorch versions on
the card.  These need a CUDA device and skip without one; they import no
JAX, so they run where the port runs:

    PYTHONPATH=src/python python -m pytest --noconftest tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have.)
"""

import json

import numpy as np
import pytest
import torch

from tpuserver_torch.ops import _build
from tpuserver_torch.ops import flash as tflash

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# Row-relative limits (as in chip_smoke.py): the largest |kernel - plain|
# of each output row over that row's largest |plain|.  bf16 rounds both
# sides to 8 mantissa bits (one ulp is at most 2^-7 of the row's largest
# value); float32 differs only in the order of summation.
CARD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _row_rel_err(out, ref):
    diff = (out.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    return (diff / scale).max().item()


@pytest.mark.parametrize("t,d,causal", [
    (200, 128, True), (200, 128, False), (200, 64, True), (200, 64, False),
    (384, 128, True), (384, 128, False)])
def test_flash_kernel_matches_plain_on_card(cuda, t, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, t, hh, d, device=cuda, generator=gen).to(
        torch.bfloat16) for hh in (8, 2, 2))
    before = tflash.flash_attention.launches
    out = tflash.flash_attention(q, k, v, causal=causal, block_q=8,
                                 block_k=8)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    ref = tflash.flash_attention_reference(q, k, v, causal=causal)
    assert _row_rel_err(out, ref) <= CARD_TOL[torch.bfloat16]
    # the limit sees a wrong kv head
    wrong = tflash.flash_attention_reference(
        q, k.roll(1, dims=2), v.roll(1, dims=2), causal=causal)
    assert _row_rel_err(wrong, ref) > CARD_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 8),
                                     (torch.bfloat16, 96)])
def test_flash_kernel_rejects_what_it_does_not_take(cuda, dtype, d):
    q = torch.zeros(1, 64, 4, d, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="bfloat16 operands with head dim"):
        tflash.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype,h,hkv,d", [
    (torch.bfloat16, 32, 8, 128), (torch.bfloat16, 8, 8, 64),
    (torch.float32, 6, 2, 16), (torch.bfloat16, 8, 1, 8)])
def test_decode_kernel_matches_plain_on_card(cuda, dtype, h, hkv, d):
    gen = torch.Generator(device=cuda).manual_seed(1)
    lengths = torch.tensor([0, 1, 300, 512], dtype=torch.int32, device=cuda)
    q = torch.randn(4, h, d, device=cuda, generator=gen).to(dtype)
    kc = torch.randn(4, 512, hkv, d, device=cuda, generator=gen).to(dtype)
    vc = torch.randn(4, 512, hkv, d, device=cuda, generator=gen).to(dtype)
    before = tflash.decode_attention.launches
    out = tflash.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert tflash.decode_attention.launches == before + 1
    ref = tflash.decode_attention_reference(q, kc, vc, lengths)
    assert _row_rel_err(out, ref) <= CARD_TOL[dtype]
    assert not out[0].any()
    # the limit sees the last 256-key tile skipped
    short = tflash.decode_attention_reference(
        q, kc, vc, torch.where(lengths > 256, lengths - 256, lengths))
    assert _row_rel_err(short, ref) > CARD_TOL[dtype]


def test_wgmma_tile_product_matches_torch_on_card(cuda):
    """The two products the flash kernel is built on, alone: TMA's
    128-byte swizzle must match the wgmma descriptors (K-major for Q and
    K, transposed for V).  S is exact products summed in fp32; O takes
    the kernel's own bf16(S), so both limits are summation order only."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(64, 128, device=cuda, generator=gen).to(
        torch.bfloat16) for _ in range(3))
    s, o = tflash.flash_tile_product(q, k, v)
    torch.cuda.synchronize()
    s_ref = q.float() @ k.float().T
    o_ref = s.to(torch.bfloat16).float() @ v.float()
    assert _row_rel_err(s, s_ref) <= 1e-5
    assert _row_rel_err(o, o_ref) <= 1e-5
    # a V read untransposed, or a swizzle off by one chunk, is far out
    assert _row_rel_err(s.to(torch.bfloat16).float() @ v.float().roll(
        1, dims=1), o_ref) > 1e-2


# the split's edges at the 8B shapes: lengths 1, 15, 16, 17 are shorter
# than the 33 splits of one stream; 16-key split and 64-key tile edges;
# a ragged batch with a 0; B 34, where one split per (row, kv head) is
# chosen
@pytest.mark.parametrize("lengths", [
    (1,), (15,), (16,), (17,), (63,), (64,), (65,), (576,), (4096,),
    (3, 0, 1000, 4096), (77,) * 34],
    ids=lambda x: "x".join(str(n) for n in x[:4]) + (
        "_b{}".format(len(x)) if len(x) > 4 else ""))
def test_split_decode_matches_both_plain_versions_on_card(cuda, lengths):
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, h, hkv, d, s = len(lengths), 32, 8, 128, 4096
    q = torch.randn(b, h, d, device=cuda, generator=gen).to(torch.bfloat16)
    kc = torch.randn(b, s, hkv, d, device=cuda, generator=gen).to(
        torch.bfloat16)
    vc = torch.randn(b, s, hkv, d, device=cuda, generator=gen).to(
        torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n_split = tflash.decode_splits(b, hkv, s, tflash._sm_count(q.device))
    if b == 34:
        assert n_split == 1
    out = tflash.decode_attention(q, kc, vc, lens)
    again = tflash.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    for ref in (tflash.decode_attention_reference(q, kc, vc, lens),
                tflash.decode_attention_split_reference(q, kc, vc, lens,
                                                        n_split)):
        assert _row_rel_err(out, ref) <= CARD_TOL[torch.bfloat16]
    for i, n in enumerate(lengths):
        if n == 0:
            assert not out[i].any()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_repeats_bit_identically_on_card(cuda, causal):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(1, 512, hh, 128, device=cuda, generator=gen).to(
        torch.bfloat16) for hh in (32, 8, 8))
    out = tflash.flash_attention(q, k, v, causal=causal)
    again = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def test_cuda_wrappers_raise_without_a_library(cuda, monkeypatch, tmp_path):
    """No silent fallback: with no kernel library, a CUDA call raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    _build.load_library.cache_clear()
    try:
        q = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
        before = (tflash.flash_attention.launches,
                  tflash.decode_attention.launches)
        with pytest.raises(RuntimeError, match="nvcc"):
            tflash.flash_attention(q, q, q)
        with pytest.raises(RuntimeError, match="nvcc"):
            tflash.decode_attention(
                q[:, 0], q, q, torch.ones(1, dtype=torch.int32, device=cuda))
        assert before == (tflash.flash_attention.launches,
                          tflash.decode_attention.launches)
    finally:
        _build.load_library.cache_clear()


# -- the continuous-batching shape: B = max_slots rows, ragged lengths -------


def _batched_decode_inputs(cuda, seed, lengths, s=4096):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b, h, hkv, d = len(lengths), 32, 8, 128
    q = torch.randn(b, h, d, device=cuda, generator=gen).to(torch.bfloat16)
    kc = torch.randn(b, s, hkv, d, device=cuda, generator=gen).to(
        torch.bfloat16)
    vc = torch.randn(b, s, hkv, d, device=cuda, generator=gen).to(
        torch.bfloat16)
    return q, kc, vc, torch.tensor(lengths, dtype=torch.int32, device=cuda)


# 8 slots at the 8B shapes: live rows at 1, 77, 600, 4096 and 3000, and
# inert rows, which the batched step gives length 1
BATCHED_LENGTHS = (1, 77, 1, 600, 4096, 1, 3000, 1)


def test_decode_kernel_at_the_batched_shape_matches_both_plain_versions(
        cuda):
    q, kc, vc, lens = _batched_decode_inputs(cuda, 6, BATCHED_LENGTHS)
    n_split = tflash.decode_splits(8, 8, 4096, tflash._sm_count(q.device))
    before = tflash.decode_attention.launches
    out = tflash.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert tflash.decode_attention.launches == before + 1
    for ref in (tflash.decode_attention_reference(q, kc, vc, lens),
                tflash.decode_attention_split_reference(q, kc, vc, lens,
                                                        n_split)):
        assert _row_rel_err(out, ref) <= CARD_TOL[torch.bfloat16]


def test_decode_kernel_row_ignores_its_slot_and_neighbours(cuda):
    """A row's output bits do not depend on its slot index or on the other
    rows: permute the rows, and give the neighbours other data and other
    lengths."""
    q, kc, vc, lens = _batched_decode_inputs(cuda, 7, BATCHED_LENGTHS)
    out = tflash.decode_attention(q, kc, vc, lens)
    perm = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4], device=cuda)
    permuted = tflash.decode_attention(q[perm], kc[perm], vc[perm],
                                       lens[perm])
    assert torch.equal(permuted, out[perm])
    q2, kc2, vc2, _ = _batched_decode_inputs(cuda, 8, BATCHED_LENGTHS)
    lens2 = torch.tensor((4096, 5, 2000, 600, 17, 1, 64, 300),
                         dtype=torch.int32, device=cuda)
    for t, t2 in ((q2, q), (kc2, kc), (vc2, vc)):
        t[3] = t2[3]  # row 3 (length 600) kept, every neighbour changed
    mixed = tflash.decode_attention(q2, kc2, vc2, lens2)
    torch.cuda.synchronize()
    assert torch.equal(mixed[3], out[3])


def test_paged_step_rows_ignore_their_slot_on_card(cuda):
    """The whole batched paged step on the card (cuBLAS matmuls, the
    decode kernel over the gathered view): permuting the slots permutes
    the logits bit for bit."""
    import dataclasses

    from tpuserver_torch.models import llama

    cfg = dataclasses.replace(
        llama.tiny(vocab=2048), d_model=1024, n_heads=8, n_kv_heads=2,
        d_ff=2048, dtype=torch.bfloat16, attn_impl="kernel")
    params = llama.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(9), cuda)
    max_seq, page, slots = 512, 16, 4
    ppseq = max_seq // page
    gen = torch.Generator(device=cuda).manual_seed(10)
    pages = llama.init_paged_kv_cache(cfg, slots * ppseq, page, cuda)
    pages.normal_(generator=gen)
    tables = torch.randperm(slots * ppseq, device=cuda, generator=gen).view(
        slots, ppseq)
    positions = torch.tensor([300, 7, max_seq, 511], device=cuda)
    tokens = torch.tensor([5, 900, 17, 2047], device=cuda)
    perm = torch.tensor([2, 0, 3, 1], device=cuda)
    with torch.inference_mode():
        logits, _ = llama.paged_batched_decode_step(
            params, pages.clone(), tokens, tables, positions, cfg)
        permuted, _ = llama.paged_batched_decode_step(
            params, pages.clone(), tokens[perm], tables[perm],
            positions[perm], cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert torch.equal(permuted, logits[perm])


def test_spec_step_is_bitwise_the_plain_chain_on_card(cuda):
    """The speculative verify on the card's kernel path (bf16, the decode
    kernel in every sub-step): full, partial and zero acceptance in one
    batch, each row bitwise equal to K+1 plain paged steps at its depth
    (tokens, logprobs, the selected logits), and the fully accepted rows'
    gathered pages equal to the plain chain's."""
    import dataclasses

    from tpuserver_torch.models import llama

    cfg = dataclasses.replace(
        llama.tiny(vocab=2048), d_model=1024, n_heads=8, n_kv_heads=2,
        d_ff=2048, dtype=torch.bfloat16, attn_impl="kernel")
    params = llama.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(11), cuda)
    max_seq, page, slots, k = 512, 16, 4, 3
    ppseq = max_seq // page
    gen = torch.Generator(device=cuda).manual_seed(12)
    pages0 = llama.init_paged_kv_cache(cfg, slots * ppseq, page, cuda)
    pages0.normal_(generator=gen)
    logits0 = torch.randn(slots, cfg.vocab, device=cuda, generator=gen)
    tables = torch.randperm(slots * ppseq, device=cuda, generator=gen).view(
        slots, ppseq)
    positions = torch.tensor([300, 7, 100, 200], device=cuda)
    active = torch.ones(slots, dtype=torch.bool, device=cuda)
    no_force = torch.zeros(slots, dtype=torch.long, device=cuda)
    with torch.inference_mode():
        pages, logits, chain = pages0.clone(), logits0.clone(), []
        for j in range(k + 1):
            tok, lp, logits, pages = llama.paged_scheduler_step(
                params, pages, logits, tables, positions + j, active,
                no_force, no_force.bool(), cfg)
            chain.append((tok, lp, logits.clone()))
        ref = torch.stack([tok for tok, _, _ in chain])
        draft = ref[1:].T.contiguous()
        draft[1, 1] = (draft[1, 1] + 1) % cfg.vocab  # wrong at index 1
        draft_len = torch.tensor([k, k, 0, k], device=cuda)
        before = tflash.decode_attention.launches
        toks, lps, accept, final, spec_pages = llama.paged_spec_step(
            params, pages0.clone(), logits0.clone(), tables, positions,
            active, no_force, no_force.bool(), draft, draft_len, cfg)
        torch.cuda.synchronize()
    assert tflash.decode_attention.launches - before == cfg.n_layers * (k + 1)
    assert accept.tolist() == [k, 1, 0, k]
    for row, depth in enumerate(accept.tolist()):
        assert torch.equal(toks[row, :depth + 1], ref[:depth + 1, row])
        for j in range(depth + 1):
            assert torch.equal(lps[row, j], chain[j][1][row])
        assert torch.equal(final[row], chain[depth][2][row])
    for row in (0, 3):
        assert torch.equal(llama.paged_gather(spec_pages, tables[row]),
                           llama.paged_gather(pages, tables[row]))


# -- CUDA IPC regions (tpuserver_torch.cuda_shared_memory) --------------------


def _child(code, *args):
    """Run ``code`` in a fresh python process (the port on its path):
    CUDA IPC opens only across processes."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "python")
    return subprocess.run(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=src))


def test_region_in_process_attach_is_the_same_memory_on_card(cuda):
    """A CUDA region is cudaMalloc memory wrapped without a copy; its raw
    handle is 64 bytes; attaching it in this process aliases the owner
    (the registry: cudaIpcOpenMemHandle refuses its own process)."""
    import base64

    from tpuserver_torch import cuda_shared_memory as csm

    h = csm.create_shared_memory_region("card", 1 << 16)
    try:
        assert h.tensor.device.type == "cuda" and not h.mapped
        assert torch.count_nonzero(h.tensor).item() == 0  # zero-filled
        raw = csm.get_raw_handle(h)
        assert len(base64.b64decode(raw)) == 64
        attached = csm.attach_from_raw_handle(raw, 4096)
        assert attached.tensor.data_ptr() == h.tensor.data_ptr()
        csm.set_shared_memory_region(attached, [torch.arange(
            8, dtype=torch.int32, device=cuda)], 16)
        view = csm.get_contents_as_tensor(h, "INT32", [8], 16)
        assert view.data_ptr() == h.tensor.data_ptr() + 16
        assert view.tolist() == list(range(8))
        attached.detach()
        attached.detach()  # an alias holds nothing: a no-op, twice
    finally:
        csm.destroy_shared_memory_region(h)
    csm.destroy_shared_memory_region(h)  # idempotent: never a double free
    with pytest.raises(csm.RegionGone):
        csm.attach_from_raw_handle(raw, 4096)


def test_region_written_by_another_process_reads_back_on_card(cuda):
    """A child process opens the handle over CUDA IPC, writes, closes its
    mapping (twice: the second is a no-op) and exits; the bytes are in
    the owner's memory.  The owner frees the region only after."""
    from tpuserver_torch import cuda_shared_memory as csm

    h = csm.create_shared_memory_region("card-x", 4096)
    try:
        code = (
            "import sys, numpy as np\n"
            "from tpuserver_torch import cuda_shared_memory as c\n"
            "a = c.attach_from_raw_handle(sys.argv[1], 4096)\n"
            "assert a.mapped\n"
            "c.set_shared_memory_region(a, [np.arange(100, 164, "
            "dtype=np.int32)], 256)\n"
            "print('read', c.get_contents_as_numpy(a, 'INT32', [2], 0)"
            ".tolist())\n"
            "a.detach(); a.detach(); print('closed')\n")
        csm.set_shared_memory_region(h, [np.array([7, 9], np.int32)])
        out = _child(code, csm.get_raw_handle(h).decode())
        assert out.returncode == 0, out.stdout
        assert "read [7, 9]" in out.stdout and "closed" in out.stdout
        got = csm.get_contents_as_numpy(h, "INT32", [64], 256)
        assert got.tolist() == list(range(100, 164))
    finally:
        csm.destroy_shared_memory_region(h)


def test_ipc_error_surfaces_as_an_exception_on_card(cuda):
    """A handle no process made fails cudaIpcOpenMemHandle: the CUDA error
    raises (with its name), in the module and as the core's typed 400 at
    registration, and nothing is registered."""
    import base64

    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.errors import BadRequest

    bogus = base64.b64encode(bytes(range(64)))
    with pytest.raises(csm.CudaSharedMemoryException,
                       match="cudaIpcOpenMemHandle failed: CUDA error"):
        csm.attach_from_raw_handle(bogus, 4096)
    core = InferenceServer()
    with pytest.raises(BadRequest, match="CUDA error") as err:
        core.register_cuda_shm("bogus", bogus, 0, 4096)
    assert err.value.code == 400 and core.cuda_shm_status() == {}


def test_kv_export_descriptor_round_trip_on_card(cuda):
    """A server-owned KV export on the card: its descriptor attaches in
    this process (the registry) and in another (CUDA IPC), both giving
    the exported bytes; a second fetch is a 409; once released, this
    process's attach of the stale descriptor is the typed 404 (the
    caller prefills), not an IPC call on freed memory."""
    import json

    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.errors import KvExportClaimed, KvExportMissing

    core = InferenceServer()
    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = torch.randn(2, 2, 1, 64, 4, 8, device=cuda,
                        generator=gen).to(torch.bfloat16)
    try:
        core.export_kv_region("g", cache, 17)
        desc = core.kv_export_descriptor("g")
        with pytest.raises(KvExportClaimed):
            core.kv_export_descriptor("g")
        got, pos = core.import_kv_descriptor(desc)
        assert pos == 17 and torch.equal(got, cache)
        code = (
            "import json, sys, torch\n"
            "from tpuserver_torch.core import InferenceServer\n"
            "got, pos = InferenceServer().import_kv_descriptor("
            "json.loads(sys.argv[1]))\n"
            "print('sum', got.float().sum().item(), pos, tuple(got.shape))\n")
        out = _child(code, json.dumps(desc))
        assert out.returncode == 0, out.stdout
        assert "sum {} 17 {}".format(cache.float().sum().item(),
                                     tuple(cache.shape)) in out.stdout
        core.drop_kv_region("g")
        with pytest.raises(KvExportMissing):
            core.import_kv_descriptor(desc)
        assert core.shm_stats()["kv_exports_dropped"] == 1
    finally:
        core.close()


# -- the W8A16 kernel (csrc/int8_matmul.cu) ----------------------------------


def _int8_inputs(cuda, seed, m, k, n):
    """bf16 activations, and an int8 weight with per-column float32
    scales as ``quantize_int8`` gives them (built here: this file imports
    no JAX, and quant.quantize_int8 is plain torch)."""
    from tpuserver_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, device=cuda, generator=gen).to(torch.bfloat16)
    w = (torch.randn(k, n, device=cuda, generator=gen) / k ** 0.5).to(
        torch.bfloat16)
    qw = quant.quantize_int8(w, axis=0)
    return x, qw["q"], qw["s"]


# the tiny preset's (K, N) (d_model 64, 8 heads of 8, 4 kv heads, d_ff
# 128, vocab 256), an odd shape that is no multiple of anything (the
# byte-wise edge path), and one of Llama-3-8B's (w_down)
INT8_SHAPES = [(64, 64), (64, 32), (64, 128), (128, 64), (64, 256),
               (37, 29), (4096 + 3, 1000 + 5), (14336, 4096)]


@pytest.mark.parametrize("k,n", INT8_SHAPES)
@pytest.mark.parametrize("m", [1, 3, 8, 40])
def test_int8_kernel_matches_plain_on_card(cuda, m, k, n):
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 10, m, k, n)
    before = quant.int8_matmul.launches
    out = quant.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches == before + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    ref = quant.int8_matmul_reference(x, q, s)
    assert _row_rel_err(out, ref) <= CARD_TOL[torch.bfloat16]
    # the limit sees the last 32 input rows of the weight skipped
    cut = q.clone()
    cut[-32:] = 0
    wrong = quant.int8_matmul_reference(x, cut, s)
    assert _row_rel_err(wrong, ref) > CARD_TOL[torch.bfloat16]
    # a 3-D input is flattened and comes back in its shape
    if m % 4 == 0:
        out3 = quant.int8_matmul(x.view(4, m // 4, k), q, s)
        assert torch.equal(out3.view(m, n), out)


@pytest.mark.parametrize("k,n", [(64, 256), (37, 29), (4096, 14336)])
def test_int8_kernel_rows_do_not_depend_on_m_on_card(cuda, k, n):
    """A row computed alone equals, bit for bit, the same row inside M 8
    and M 40, wherever it sits and whatever its neighbours hold."""
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 11, 40, k, n)
    alone = torch.cat([quant.int8_matmul(x[i:i + 1], q, s)
                       for i in range(40)])
    for m in (2, 4, 8, 16, 40):
        for j in range(0, 40, m):
            part = quant.int8_matmul(x[j:j + m], q, s)
            assert torch.equal(part, alone[j:j + m]), (m, j)
    rolled = quant.int8_matmul(x.roll(5, dims=0), q, s)
    assert torch.equal(rolled, alone.roll(5, dims=0))
    noisy = x.clone()
    noisy[1:] = torch.randn_like(noisy[1:].float()).to(torch.bfloat16)
    assert torch.equal(quant.int8_matmul(noisy[:8], q, s)[0], alone[0])


@pytest.mark.parametrize("n", [72, 200, 1000])
@pytest.mark.parametrize("k", [80, 1000, 1040])
def test_int8_kernel_ragged_tile_edges_on_card(cuda, k, n):
    """K no multiple of the split, the 64-row stage or the MMA's 16; N no
    multiple of the 128-column tile (72 and 200 are no multiple of the
    16-byte chunk either: the byte-load path), at 1, 8 and 40 rows."""
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 15, 40, k, n)
    for m in (1, 8, 40):
        out = quant.int8_matmul(x[:m], q, s)
        ref = quant.int8_matmul_reference(x[:m], q, s)
        assert out.shape == (m, n)
        assert _row_rel_err(out, ref) <= CARD_TOL[torch.bfloat16], m
        assert torch.equal(out, quant.int8_matmul(x[:m], q, s)), m


def test_int8_kernel_rows_alone_at_every_m_on_card(cuda):
    """Every M from 1 to 40 at one 8B shape (wq's, split K): each row
    equals, bit for bit, the same row computed alone."""
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 16, 40, 4096, 4096)
    alone = torch.cat([quant.int8_matmul(x[i:i + 1], q, s)
                       for i in range(40)])
    for m in range(1, 41):
        assert torch.equal(quant.int8_matmul(x[:m], q, s), alone[:m]), m


def test_int8_kernel_takes_a_strided_x_on_card(cuda):
    """x with a row stride above K (a view of wider rows, and one whose
    rows are not 16-byte aligned) gives the contiguous x's bits."""
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 17, 8, 1040, 200)
    want = quant.int8_matmul(x, q, s)
    for pad in (8, 3):
        wide = torch.zeros(8, 1040 + pad, dtype=torch.bfloat16, device=cuda)
        wide[:, pad:] = x
        view = wide[:, pad:]
        assert view.stride(0) == 1040 + pad
        assert torch.equal(quant.int8_matmul(view, q, s), want), pad


@pytest.mark.parametrize("n", [256, 200])
def test_int8_kernel_converts_every_int8_exactly_on_card(cuda, n):
    """A weight whose every column holds -127..127 (255 rows), one-hot x
    rows: y[m, n] must be bf16(q[m, n] * bf16(s[n])) exactly, so each of
    the 255 values goes through the int8 -> bf16 conversion unchanged."""
    from tpuserver_torch.ops import quant

    k = 255
    idx = torch.arange(k, device=cuda)
    q = ((idx[:, None] + torch.arange(n, device=cuda)[None, :]) % k
         - 127).to(torch.int8)
    gen = torch.Generator(device=cuda).manual_seed(18)
    s = torch.rand(n, device=cuda, generator=gen) + 0.5
    x = torch.eye(k, dtype=torch.bfloat16, device=cuda)
    want = (q.float() * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    for rows in (slice(0, 8), slice(0, 40), slice(0, k)):
        assert torch.equal(quant.int8_matmul(x[rows], q, s), want[rows])


def test_int8_kernel_rejects_what_it_does_not_take(cuda):
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 12, 2, 64, 32)
    with pytest.raises(ValueError, match="bfloat16"):
        quant.int8_matmul(x.float(), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        quant.int8_matmul(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="do not match"):
        quant.int8_matmul(x[:, :63], q, s)


def test_int8_wrapper_raises_without_a_library(cuda, monkeypatch, tmp_path):
    """No silent fallback: with no kernel library, a CUDA call raises."""
    from tpuserver_torch.ops import quant

    x, q, s = _int8_inputs(cuda, 13, 2, 64, 32)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    _build.load_library.cache_clear()
    try:
        before = quant.int8_matmul.launches
        with pytest.raises(RuntimeError, match="nvcc"):
            quant.int8_matmul(x, q, s)
        assert quant.int8_matmul.launches == before
    finally:
        _build.load_library.cache_clear()


def test_w8a8_product_is_exact_on_card(cuda):
    """The w8a8 product's int8 x int8 -> int32 step (``torch._int_mm``,
    rows padded to 32 when 16 or fewer) against the exact product, in
    float64 (every sum is an integer below 2^53)."""
    from tpuserver_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randint(-127, 128, (4096, 1024), device=cuda,
                      generator=gen).to(torch.int8)
    for rows in (1, 8, 16, 17, 40, 512):
        xq = torch.randint(-127, 128, (rows, 4096), device=cuda,
                           generator=gen).to(torch.int8)
        got = quant._int8_product(xq, q)
        exact = (xq.double() @ q.double()).to(torch.int32)
        assert got.shape == (rows, 1024) and torch.equal(got, exact), rows


# -- the vision zoo (bf16 forwards against float32 on the card) ---------------

# as chip_smoke.py's VISION_TOL: bf16 logits against float32 after the
# full depth (about 3e-3 on the CPU); a skipped last convolution moves
# them by 0.13 to 0.67
VISION_TOL = 1e-2


@pytest.mark.parametrize("name", ["resnet50", "densenet121"])
def test_vision_bf16_forward_matches_float32_on_card(cuda, name):
    from tpuserver_torch.models import vision as tv

    cls = {"resnet50": tv.ResNet50Model,
           "densenet121": tv.DenseNet121Model}[name]
    model = cls(device=cuda, seed=0)
    p32 = tv.tree_cast(model.params(), torch.float32)
    x = torch.rand((4, 224, 224, 3), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            served = model.logits(x)
            ref = model.logits(x, p32)
            faulty = tv.tree_map(lambda t: t, p32)
            if name == "resnet50":
                blk = faulty["stages"][-1][-1]
                blk["w3"] = torch.zeros_like(blk["w3"])
            else:
                blk = faulty["blocks"][-1][-1]
                blk["w2"] = torch.zeros_like(blk["w2"])
            bad = model.logits(x, faulty)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    assert served.dtype == torch.bfloat16 and served.shape == (4, 1000)
    assert _row_rel_err(served, ref) <= VISION_TOL
    assert _row_rel_err(bad, ref) > VISION_TOL


def test_cuda_region_input_equals_inband_on_card(cuda):
    """ResNet-50 through the core: the image from a CUDA region (the
    model reads a view of it) and the output into another region, equal
    to the in-band answer."""
    import base64

    import numpy as np

    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import (InferenceServer, InferRequest,
                                      RequestedOutput)
    from tpuserver_torch.models import vision as tv

    model = tv.ResNet50Model(device=cuda, seed=0)
    core = InferenceServer([model])
    image = np.random.RandomState(0).rand(1, 224, 224, 3).astype(np.float32)
    region_in = csm.create_shared_memory_region("card_in", image.nbytes)
    region_out = csm.create_shared_memory_region("card_out", 4000)
    try:
        csm.set_shared_memory_region(region_in, [image])
        for name, h in (("card_in", region_in), ("card_out", region_out)):
            core.register_cuda_shm(
                name, base64.b64encode(base64.b64decode(
                    csm.get_raw_handle(h))), 0, h.byte_size)
        inband = core.infer(InferRequest("resnet50", inputs={
            "INPUT": image})).outputs[0][1]
        view = core.read_shm_input("card_in", image.nbytes, 0, "FP32",
                                   list(image.shape))
        assert view.data_ptr() == region_in.tensor.data_ptr()
        core.infer(InferRequest(
            "resnet50", inputs={"INPUT": view},
            requested_outputs=[RequestedOutput(
                "OUTPUT", shm_region="card_out", shm_byte_size=4000)]))
        got = csm.get_contents_as_numpy(region_out, np.float32, [1, 1000])
        assert _row_rel_err(torch.from_numpy(got),
                            torch.from_numpy(inband)) <= VISION_TOL
    finally:
        core.unregister_cuda_shm("card_in")
        core.unregister_cuda_shm("card_out")
        core.close()
        csm.destroy_shared_memory_region(region_in)
        csm.destroy_shared_memory_region(region_out)


def test_a_model_output_reads_back_complete_on_card(cuda):
    """A ``TorchModel``'s output is read for a response on the shm copy
    stream (``cuda_shared_memory.to_host``), which does not wait for the
    model's stream: ``execute`` finishes its outputs first.  The model
    holds its stream for about 50 ms before it writes the output, and
    each call's values differ from the last's, whose freed block the
    next output may reuse."""
    from tpuserver_torch.core import InferenceServer, TensorSpec, TorchModel

    class Slow(TorchModel):
        name = "slow"
        inputs = (TensorSpec("X", "FP32", [4096]),)
        outputs = (TensorSpec("Y", "FP32", [4096]),)

        def forward(self, X):
            torch.cuda._sleep(int(1e8))
            return {"Y": X * 2 + 1}

    model = Slow(device=cuda)
    for i in range(3):
        x = np.arange(4096, dtype=np.float32) + 4096 * i
        out = model.execute({"X": x}, None)
        got = InferenceServer._host_array(out["Y"], "FP32")
        np.testing.assert_array_equal(got, x * 2 + 1)



def test_perf_analyzer_cuda_shm_is_zero_copy_on_card(cuda, capsys):
    """The perf analyzer's in-process backend with ``--shared-memory
    cuda`` on ``simple``: every input of every request is a view of a
    CUDA region (``shm_zero_copy_reads`` rises by one per input read:
    two a request, ``simple`` having two inputs), the outputs land in a
    CUDA region equal to the in-band ones, and no region is left."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch import perf_analyzer
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.models import default_models
    from tpuserver_torch.perfanalyzer.client_backend import (
        InProcessBackend,
        ShmInferDataManager,
        build_input_pool,
    )

    core = InferenceServer(default_models())
    backend = InProcessBackend(core)
    try:
        def counts():
            stats = backend.stats_snapshot("simple")
            return (core.shm_stats()["shm_zero_copy_reads"],
                    stats["success_count"])

        reads0, done0 = counts()
        rc = perf_analyzer.main(
            ["-m", "simple", "--shared-memory", "cuda",
             "--output-shared-memory-size", "64", "--concurrency-range",
             "1:2", "--measurement-interval", "200", "--max-trials", "3",
             "--warmup", "0"], core=core)
        out = capsys.readouterr().out
        assert rc == 0, out
        rows = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"')]
        assert [r["errors"] for r in rows] == [0, 0]
        reads1, done1 = counts()
        assert done1 > done0
        assert reads1 - reads0 == 2 * (done1 - done0)

        shm = ShmInferDataManager(backend, "cuda", tag="card", device=cuda)
        try:
            metadata = backend.model_metadata("simple")
            pool = build_input_pool(
                metadata, backend.model_config("simple"), pool_size=3,
                batch_size=2, seed=1)
            refs = shm.stage_input_sets(pool, {
                t["name"]: t["datatype"] for t in metadata["inputs"]})
            name, handle = shm.create_region("out", 256)
            prepared = backend.prepare_shm(
                "simple", refs, [("OUTPUT0", name, 128, 0),
                                 ("OUTPUT1", name, 128, 128)])
            for inputs, req in zip(pool, prepared):
                inband = backend.infer(backend.prepare("simple", [inputs])[0])
                backend.infer(req)
                for j, (spec, array) in enumerate(inband.outputs):
                    np.testing.assert_array_equal(
                        shm.read(handle, np.int32, [2, 16], offset=128 * j),
                        array)
        finally:
            shm.close()
    finally:
        backend.close()
        core.close()
    assert not core.cuda_shm_status()
    # the perf analyzer's regions are named pa_<tag>_<label>
    assert not [h.name for h in csm.allocated_shared_memory_regions()
                if h.name.startswith("pa_")]
