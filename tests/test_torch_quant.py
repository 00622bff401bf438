"""The port's int8 quantization ops (tpuserver_torch.ops.quant) held
against the JAX package's (tpuserver.ops.quant) on the same seeded numpy
inputs, on the CPU, where the W8A16 wrapper runs its plain version.

Tolerances: ``quantize_int8`` bit for bit (both compute in float32, with
round half to even); the w8a8 product at float32 within 1e-6 relative
(the int8 x int8 -> int32 product is exact on both sides, and the rescale
is the same two float32 products); the weight-only product within 1e-6
relative at float32 and 1e-2 of the largest |reference| at bfloat16 (both
sides round the f32-accumulated sum to bfloat16, but may sum in another
order, which can move a rounding by one bf16 step: 2^-8 of a value).
Shapes are deliberately no multiples of 8."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tpuserver.ops import quant as jq
from tpuserver_torch.ops import quant as tq

pytestmark = pytest.mark.torch_port

K, N = 37, 29
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The float32 numpy array ``a`` as a JAX array and a torch tensor of
    ``dtype``, rounded alike (round to nearest even from float32)."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    """A JAX array or a torch tensor as float32 numpy (int8 and int32 as
    they are)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(
        a.dtype) == "bfloat16" else a


def _weight(seed=0, shape=(K, N)):
    return np.random.RandomState(seed).standard_normal(shape) * 0.05


def _quantized(dtype, axis=0, seed=0, shape=(K, N)):
    jw, tw = _pair(_weight(seed, shape), dtype)
    return jq.quantize_int8(jw, axis), tq.quantize_int8(tw, axis)


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax_bitwise(dtype, axis):
    jqw, tqw = _quantized(dtype, axis)
    assert tqw["q"].dtype == torch.int8 and tqw["s"].dtype == torch.float32
    assert tqw["s"].shape == ((N,) if axis == 0 else (K,))
    np.testing.assert_array_equal(_np(tqw["q"]), _np(jqw["q"]))
    np.testing.assert_array_equal(_np(tqw["s"]), _np(jqw["s"]))


def test_quantize_int8_all_zero_channel_and_rejects_non_2d():
    w = _weight()
    w[:, 3] = 0.0  # a zero channel takes the 1e-8 floor, as in JAX
    jqw, tqw = jq.quantize_int8(jnp.asarray(w, jnp.float32)), \
        tq.quantize_int8(torch.from_numpy(w).float())
    np.testing.assert_array_equal(_np(tqw["s"]), _np(jqw["s"]))
    np.testing.assert_array_equal(_np(tqw["q"]), _np(jqw["q"]))
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_int8(torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_int8(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("shape", [(1, K), (3, K), (2, 5, K)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_matmul_matches_jax(dtype, shape):
    """Few rows (and 2-D inputs): the weight-only product."""
    jqw, tqw = _quantized(dtype)
    jx, tx = _pair(np.random.RandomState(1).standard_normal(shape), dtype)
    got, ref = tq.matmul(tx, tqw), jq.matmul(jx, jqw)
    assert got.dtype == tx.dtype and got.shape == shape[:-1] + (N,)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert _rel(_np(got), _np(ref)) <= tol


@pytest.mark.parametrize("shape", [(1, 8, K), (2, 9, K), (1, 40, K)])
def test_w8a8_matmul_matches_jax_at_float32(shape):
    """>= 8 rows of a >= 3-D activation: per-row int8 activations, an
    exact int32 product, and the float32 rescale."""
    jqw, tqw = _quantized("float32")
    jx, tx = _pair(np.random.RandomState(2).standard_normal(shape),
                   "float32")
    got, ref = _np(tq.matmul(tx, tqw)), _np(jq.matmul(jx, jqw))
    assert got.shape == shape[:-1] + (N,)
    assert _rel(got, ref) <= 1e-6


def test_int8_product_is_exact_with_padded_rows():
    """``torch._int_mm`` rows <= 16 are padded with zero rows: the int32
    product equals the exact one at 1, 16, 17 and 40 rows."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randint(-127, 128, (40, 24)).astype(np.int8))
    for rows in (1, 16, 17, 40):
        xq = torch.from_numpy(
            rng.randint(-127, 128, (rows, 40)).astype(np.int8))
        got = tq._int8_product(xq, q)
        assert got.dtype == torch.int32 and got.shape == (rows, 24)
        assert torch.equal(got, xq.int() @ q.int())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regime_rule_follows_jax(dtype):
    """T 7 takes the weight-only product and T 8 the w8a8 one, as in JAX;
    a 2-D input of 9 rows (a batch) stays weight-only."""
    jqw, tqw = _quantized(dtype)
    rng = np.random.RandomState(4)
    for shape, w8a8 in (((1, 7, K), False), ((1, 8, K), True),
                        ((9, K), False)):
        jx, tx = _pair(rng.standard_normal(shape), dtype)
        got = tq.matmul(tx, tqw)
        want = (tq._w8a8_matmul(tx, tqw) if w8a8
                else tq.int8_matmul_reference(tx, tqw["q"], tqw["s"]))
        assert torch.equal(got, want), shape
        tol = 1e-6 if dtype == "float32" else 1e-2
        assert _rel(_np(got), _np(jq.matmul(jx, jqw))) <= tol, shape


def test_2d_rows_are_batch_invariant():
    """A bf16 [B, D] row alone equals, bit for bit, the same row inside a
    batch of 9: the regime never switches with the server-side batch (as
    the JAX test pins, in bf16; on the CPU a float32 product of one row
    takes another BLAS routine than one of nine, whose sums differ in
    their last bits with or without quantization)."""
    _, tqw = _quantized("bfloat16")
    one = _pair(np.random.RandomState(5).standard_normal((1, K)),
                "bfloat16")[1]
    batched = torch.cat([one] * 9)
    assert torch.equal(tq.matmul(one, tqw)[0], tq.matmul(batched, tqw)[0])


@pytest.mark.parametrize("quantized", [False, True])
def test_gather_rows_matches_jax(quantized):
    """Default (bf16) and given dtypes, from a plain table and from a
    row-quantized one (``axis=1``: one scale a row)."""
    jw, tw = _pair(_weight(6, (50, 16)), "bfloat16")
    if quantized:
        jw, tw = jq.quantize_int8(jw, axis=1), tq.quantize_int8(tw, axis=1)
    idx = np.array([[0, 5, 5], [49, 1, 7]])
    for dtype in (None, "float32", "bfloat16"):
        kw_j = {} if dtype is None else {"dtype": DTYPES[dtype][0]}
        kw_t = {} if dtype is None else {"dtype": DTYPES[dtype][1]}
        got = tq.gather_rows(tw, torch.from_numpy(idx), **kw_t)
        ref = jq.gather_rows(jw, jnp.asarray(idx), **kw_j)
        # a plain table keeps its dtype; a quantized one dequantizes into
        # the given dtype, bf16 by default
        want = (DTYPES[dtype][1] if quantized and dtype is not None
                else torch.bfloat16)
        assert got.dtype == want and got.shape == (2, 3, 16)
        np.testing.assert_array_equal(_np(got), _np(ref))


def test_quantized_bytes_match_jax():
    jw, tw = _pair(_weight(), "bfloat16")
    jqw, tqw = jq.quantize_int8(jw), tq.quantize_int8(tw)
    assert tq.quantized_bytes(tqw) == jq.quantized_bytes(jqw) == K * N + 4 * N
    assert tq.quantized_bytes(tw) == jq.quantized_bytes(jw) == K * N * 2
    assert tq.quantized_bytes(tw.float()) == K * N * 4
    assert not tq.is_quantized(tw) and tq.is_quantized(tqw)


@pytest.mark.parametrize("shape", [(1, K), (8, K), (40, K), (2, 3, K)])
def test_int8_matmul_reference_is_the_weight_only_matmul(shape):
    """The kernel's plain version is the weight-only product, in its
    order of roundings; on CPU tensors the wrapper runs it and counts no
    launch."""
    _, tqw = _quantized("bfloat16")
    tx = _pair(np.random.RandomState(7).standard_normal(shape),
               "bfloat16")[1]
    ref = tq.int8_matmul_reference(tx, tqw["q"], tqw["s"])
    want = ((tx @ tqw["q"].to(torch.bfloat16))
            * tqw["s"].to(torch.bfloat16)).to(torch.bfloat16)
    assert torch.equal(ref, want)
    before = tq.int8_matmul.launches
    assert torch.equal(tq.int8_matmul(tx, tqw["q"], tqw["s"]), ref)
    assert tq.int8_matmul.launches == before
    if len(shape) == 2 and shape[0] < 8:
        assert torch.equal(tq.matmul(tx, tqw), ref)


class _KernelReached(Exception):
    pass


def test_int8_matmul_raises_on_cuda_tensors_without_a_card(monkeypatch):
    """CUDA tensors (fake ones: this machine has no card) never take the
    CPU path: a float16 activation (outside the kernel's domain) or a
    transposed weight is a ValueError, and bf16 and float32 operands go
    for the kernel library (here a stub that raises)."""
    def no_library():
        raise _KernelReached()

    monkeypatch.setattr(tq._build, "load_library", no_library)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(3, K, device="cuda", dtype=torch.bfloat16)
        q = torch.empty(K, N, device="cuda", dtype=torch.int8)
        s = torch.empty(N, device="cuda")
        with pytest.raises(ValueError, match="outside the kernel's domain"):
            tq.int8_matmul(x.half(), q, s)
        with pytest.raises(ValueError, match="contiguous"):
            tq.int8_matmul(x, torch.empty(N, K, device="cuda",
                                          dtype=torch.int8).t(), s)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a fake tensor's data_ptr
            for xx in (x, x.float()):
                with pytest.raises(_KernelReached):
                    tq.int8_matmul(xx, q, s)
    with pytest.raises(ValueError, match="do not match"):
        tq.int8_matmul(torch.zeros(2, K + 1), torch.zeros(K, N,
                                                          dtype=torch.int8),
                       torch.zeros(N))


@pytest.mark.parametrize("k,n,want", [
    (4096, 4096, (16, 256)), (4096, 1024, (16, 256)),
    (4096, 14336, (4, 1024)), (14336, 4096, (14, 1024)),
    (4096, 128256, (4, 1024)), (64, 64, (1, 256)), (37, 29, (1, 256)),
    (4099, 1005, (9, 512))])
def test_int8_splits_follow_the_weight_shape_alone(k, n, want):
    """The kernel's cut of K: whole multiples of 256 rows, at most 1024,
    that cover K, from (K, N) alone (the Llama-3-8B shapes and the tiny ones), so a
    row's sum runs in one order whatever the number of rows."""
    n_split, rows = tq.int8_splits(k, n)
    assert (n_split, rows) == want
    assert rows % 256 == 0 and rows <= 1024
    assert n_split * rows >= k > (n_split - 1) * rows


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (14336, 4096),
                                 (4096, 128256), (37, 29), (4099, 1005)])
def test_int8_scratch_follows_the_weight_shape_and_rows(k, n):
    """The launch's scratch: the split is the same at every row count (it
    comes from (K, N) alone); with more than one split the float32 partial
    sums are [n_split, M, N] and there is one ticket a tile of 128 columns
    and up to 40 rows (the kernel's five n8 MMA tiles), none with one."""
    want = tq.int8_splits(k, n)
    for m in (1, 2, 7, 8, 9, 39, 40, 41, 80, 81, 512):
        n_split, rows, part, tickets = tq.int8_scratch(m, k, n)
        assert (n_split, rows) == want
        if n_split == 1:
            assert part is None and tickets == 0
        else:
            assert part == (n_split, m, n)
            assert tickets == -(-n // 128) * -(-m // 40)
