"""The kernels' whole reference domain: the JAX package's Pallas kernels
(tpuserver.ops.flash, in interpret mode as tests/test_torch_flash.py runs
them) against the port's plain versions at the shapes the port's kernels
take at every head dim: flash at head dims 96 and 256 over one kv head,
float32 and bf16, causal and not; decode at 16 and 32 query heads per kv
head, head dim 96 (also through the model of the kernel's split-K).  The same numpy inputs feed both; on the CPU the
port's wrappers run their plain versions.  The kernels themselves are
held against those plain versions on the card (tests/test_torch_card.py,
chip_smoke.py phases 3 and 20).  The weight-only product in float32 at
1 and 3 rows is tests/test_torch_quant.py's
``test_weight_only_matmul_matches_jax``.

Also the route tables as plain functions: every (dtype, head dim, query
heads per kv head) of the JAX kernels' domain that the card's rule on
rows takes has a route (the tensor cores for bf16, "simt" for float32),
the decode kernel's head groups by route, and what stays outside raises
ValueError with the reason.

Tolerances (tests/test_torch_flash.py's): 2e-4 in float32 (both sides sum
in float32, in another order), 5e-2 in bfloat16 (the JAX kernel rounds
its probabilities to bf16 before the P.V product; the plain version does
not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.ops import flash as jflash
from tpuserver_torch.ops import flash as tflash
from tpuserver_torch.ops import quant as tquant

pytestmark = pytest.mark.torch_port

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor."""
    return (jnp.asarray(a, JNP[dtype]),
            torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype]))


def _close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(
        torch_out.float().numpy(), np.asarray(jax_out, np.float32),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_other_head_dims_over_one_kv_head_matches_jax(d, dtype,
                                                                causal):
    """Multi-query attention (Hkv 1) at head dims the tensor-core route
    does not take; JAX gets K/V expanded to every query head."""
    rng = np.random.RandomState(d + (7 if causal else 0))
    h = 4
    q = rng.randn(1, 32, h, d).astype(np.float32)
    k = rng.randn(1, 32, 1, d).astype(np.float32)
    v = rng.randn(1, 32, 1, d).astype(np.float32)
    ref = jflash.flash_attention(
        *(_pair(a, dtype)[0] for a in (q, np.repeat(k, h, axis=2),
                                       np.repeat(v, h, axis=2))),
        causal=causal, block_q=16, block_k=16)
    out = tflash.flash_attention(*(_pair(a, dtype)[1] for a in (q, k, v)),
                                 causal=causal, block_q=16, block_k=16)
    assert out.dtype == TORCH[dtype] and out.shape == q.shape
    _close(ref, out, dtype)


@pytest.mark.parametrize("n_rep,h_kv", [(16, 1), (16, 2), (32, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_at_many_heads_per_kv_head_matches_jax(n_rep, h_kv, dtype):
    """More than 8 query heads per kv head (the kernel puts them in
    groups of 16 on "mma", 8 on "simt"), head dim 96 (padded to 128 on
    "mma"; a SIMT team of 12 lanes rounded up to 16 on "simt"); ragged
    lengths, one of them 0."""
    rng = np.random.RandomState(n_rep + h_kv)
    b, s, d = 2, 64, 96
    h = n_rep * h_kv
    q = rng.randn(b, h, d).astype(np.float32)
    kc = rng.randn(b, s, h_kv, d).astype(np.float32)
    vc = rng.randn(b, s, h_kv, d).astype(np.float32)
    lens = np.asarray([40, 0], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kc, vc))
    ref = jflash.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=16)
    out = tflash.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                  block_k=16)
    assert out.dtype == TORCH[dtype] and out.shape == (b, h, d)
    _close(ref, out, dtype)
    assert not out[1].any()


@pytest.mark.parametrize("n_split", [1, 3, 64])
def test_decode_split_model_at_many_heads_per_kv_head_matches_jax(n_split):
    """The split-K model of the decode kernel (each split's partial per
    query head, combined in split order) at 16 query heads per kv head,
    head dim 96."""
    rng = np.random.RandomState(11)
    b, h, h_kv, s, d = 3, 32, 2, 128, 96
    q = rng.randn(b, h, d).astype(np.float32)
    kc = rng.randn(b, s, h_kv, d).astype(np.float32)
    vc = rng.randn(b, s, h_kv, d).astype(np.float32)
    lens = np.asarray([1, 77, 128], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (q, kc, vc))
    ref = jflash.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=32)
    out = tflash.decode_attention_split_reference(
        tq, tk, tv, torch.from_numpy(lens), n_split)
    _close(ref, out, "float32")


# -- the route tables ---------------------------------------------------------


HEAD_DIMS = range(8, 257, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_head_dim_of_the_domain_has_a_route(dtype):
    """bf16 takes the tensor cores at every head dim of the domain,
    float32 the CUDA cores' float32 FMA ("simt")."""
    tensor_cores = dtype == torch.bfloat16
    for d in HEAD_DIMS:
        assert tflash.flash_route(dtype, d) == (
            "wgmma" if tensor_cores else "simt"), d
        for n_rep in (1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 128):
            assert tflash.decode_route(dtype, d, n_rep) == (
                "mma" if tensor_cores else "simt"), (d, n_rep)


@pytest.mark.parametrize("route,group", [("mma", 16), ("simt", 8)])
def test_decode_groups_hold_up_to_their_routes_heads(route, group):
    """A decode block takes up to 16 query heads of a kv head on "mma"
    (the MMA's rows), 8 on "simt": 16 heads are one group on "mma", 17
    are two; multi-query at 32 heads is two groups, Llama-3.1-405B's 16
    heads a kv head one."""
    assert tflash.DECODE_GROUP_HEADS[route] == group
    for n_rep in range(1, 130):
        groups = tflash.decode_head_groups(route, n_rep)
        assert (groups - 1) * group < n_rep <= groups * group, n_rep
    assert tflash.decode_head_groups(route, group) == 1
    assert tflash.decode_head_groups(route, group + 1) == 2
    if route == "mma":
        assert tflash.decode_head_groups("mma", 32) == 2
        assert tflash.decode_head_groups("mma", 128 // 8) == 1


def test_routes_name_the_kernels_routes():
    assert tflash.FLASH_ROUTES == ("wgmma", "simt")
    assert tflash.DECODE_ROUTES == ("mma", "simt")
    assert tquant.INT8_ROUTES == ("mma", "simt")
    assert set(tflash.flash_attention.route_launches) == set(
        tflash.FLASH_ROUTES)
    assert set(tflash.decode_attention.route_launches) == set(
        tflash.DECODE_ROUTES)
    assert set(tquant.int8_matmul.route_launches) == set(tquant.INT8_ROUTES)


@pytest.mark.parametrize("dtype,d,what", [
    (torch.float16, 128, "dtype"), (torch.float64, 64, "dtype"),
    (torch.bfloat16, 4, "head dim"), (torch.float32, 12, "head dim"),
    (torch.bfloat16, 264, "head dim"), (torch.float32, 512, "head dim")])
def test_what_stays_outside_raises_with_its_reason(dtype, d, what):
    for call in (lambda: tflash.flash_route(dtype, d),
                 lambda: tflash.decode_route(dtype, d, 4)):
        with pytest.raises(ValueError, match="{} .* is outside the "
                           "kernels' domain".format(what)):
            call()


def test_decode_route_wants_a_kv_head_for_every_query_group():
    with pytest.raises(ValueError, match="query heads per kv head"):
        tflash.decode_route(torch.bfloat16, 128, 0)


def test_int8_route_follows_the_activation_dtype():
    assert tquant.int8_route(torch.bfloat16) == "mma"
    assert tquant.int8_route(torch.float32) == "simt"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="outside the kernel's domain"):
            tquant.int8_route(dtype)


def test_cpu_tensors_count_no_route_launch():
    """On the CPU the plain versions run: no launch, total or by route,
    at any of the new routes' shapes."""
    tflash.reset_launch_counts()
    tquant.reset_launch_counts()
    q = torch.randn(1, 32, 4, 96)
    kv = torch.randn(1, 32, 1, 96)
    tflash.flash_attention(q, kv, kv, block_q=16, block_k=16)
    tflash.decode_attention(q[:, 0], kv, kv, torch.tensor([5]), block_k=16)
    w = tquant.quantize_int8(torch.randn(96, 40))
    tquant.int8_matmul(torch.randn(3, 96), w["q"], w["s"])
    assert tflash.flash_attention.launches == 0
    assert tflash.decode_attention.launches == 0
    assert tquant.int8_matmul.launches == 0
    for counts in (tflash.flash_attention.route_launches,
                   tflash.decode_attention.route_launches,
                   tquant.int8_matmul.route_launches):
        assert not any(counts.values())
