"""The port's attention kernels (tpuserver_torch.ops.flash) held against
the JAX package's Pallas kernels (tpuserver.ops.flash), which run in
interpret mode on the CPU as tests/test_ops.py runs them.  The same
numpy inputs feed both; on the CPU the port's wrappers run their plain
PyTorch versions.  The kernel-versus-plain tests are in
tests/test_torch_card.py.

Tolerances: 2e-4 in float32 (both sides sum in float32, in another
order), 5e-2 in bfloat16 (the JAX kernel rounds its probabilities to
bf16 before the P.V product; the plain version does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.ops import flash as jflash
from tpuserver_torch.ops import _build
from tpuserver_torch.ops import flash as tflash

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


# -- flash_attention ----------------------------------------------------------


@pytest.mark.parametrize("shape,causal,bq,bk,dtype,seed", [
    ((2, 64, 4, 16), True, 16, 16, "float32", 0),     # causal
    ((1, 96, 2, 8), False, 32, 16, "float32", 1),     # uneven blocks
    ((1, 32, 2, 8), True, 16, 16, "bfloat16", 2),     # bf16 operands
    ((2, 128, 4, 8), True, 128, 128, "float32", 3),   # one block
], ids=["causal", "noncausal_uneven", "bf16", "one_block"])
def test_flash_attention_matches_jax(shape, causal, bq, bk, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                 block_k=bk)
    out = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                                 block_k=bk)
    assert out.dtype == TORCH[dtype] and out.shape == shape
    _close(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_native_gqa_matches_jax_on_expanded_kv(dtype):
    """The port reads kv head h // n_rep itself; JAX gets K/V expanded."""
    rng = np.random.RandomState(6)
    q = rng.randn(2, 64, 6, 16).astype(np.float32)
    k = rng.randn(2, 64, 2, 16).astype(np.float32)
    v = rng.randn(2, 64, 2, 16).astype(np.float32)
    ref = jflash.flash_attention(
        *(_pair(a, dtype)[0] for a in (q, np.repeat(k, 3, axis=2),
                                       np.repeat(v, 3, axis=2))),
        block_q=16, block_k=32)
    out = tflash.flash_attention(
        *(_pair(a, dtype)[1] for a in (q, k, v)), block_q=16, block_k=32)
    _close(ref, out, dtype)


def test_flash_attention_block_divisibility_error_matches_jax():
    jq = jnp.zeros((1, 48, 2, 8), jnp.float32)
    tq = torch.zeros((1, 48, 2, 8))
    with pytest.raises(ValueError, match="divide"):
        jflash.flash_attention(jq, jq, jq, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="divide"):
        tflash.flash_attention(tq, tq, tq, block_q=32, block_k=32)


def test_flash_attention_rejects_bad_gqa():
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tflash.flash_attention(torch.zeros(1, 16, 6, 8),
                               torch.zeros(1, 16, 4, 8),
                               torch.zeros(1, 16, 4, 8))


# -- decode_attention ---------------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,s,d,lengths,block_k,dtype,seed", [
    (2, 6, 2, 64, 16, [40, 17], 16, "float32", 4),     # GQA, ragged
    (1, 4, 4, 32, 8, [1], 8, "float32", 5),            # length 1, no GQA
    (3, 8, 4, 64, 8, [0, 64, 33], 16, "float32", 7),   # length 0 and full
    (2, 8, 2, 128, 16, [100, 5], 32, "bfloat16", 8),   # bf16
], ids=["gqa_ragged", "length1", "length0_full", "bf16"])
def test_decode_attention_matches_jax(b, h, hkv, s, d, lengths, block_k,
                                      dtype, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    kc = rng.randn(b, s, hkv, d).astype(np.float32)
    vc = rng.randn(b, s, hkv, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kc, vc))
    ref = jflash.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                  block_k=block_k)
    out = tflash.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                  block_k=block_k)
    assert out.dtype == TORCH[dtype] and out.shape == (b, h, d)
    _close(ref, out, dtype)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not out[i].any()


def test_decode_attention_errors_match_jax():
    q = torch.zeros(1, 6, 8)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tflash.decode_attention(q, torch.zeros(1, 32, 4, 8),
                                torch.zeros(1, 32, 4, 8),
                                torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="divide by block_k"):
        tflash.decode_attention(q, torch.zeros(1, 48, 2, 8),
                                torch.zeros(1, 48, 2, 8),
                                torch.ones(1, dtype=torch.int32), block_k=32)
    with pytest.raises(ValueError, match="divide by block_k"):
        jflash.decode_attention(jnp.zeros((1, 6, 8)),
                                jnp.zeros((1, 48, 2, 8)),
                                jnp.zeros((1, 48, 2, 8)),
                                jnp.ones((1,), jnp.int32), block_k=32)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tflash.reset_launch_counts()
    q = torch.randn(1, 32, 4, 8)
    tflash.flash_attention(q, q, q, block_q=16, block_k=16)
    tflash.decode_attention(q[:, 0], q, q, torch.tensor([5]), block_k=16)
    assert tflash.flash_attention.launches == 0
    assert tflash.decode_attention.launches == 0


def test_build_hash_tracks_sources():
    """The library is rebuilt when a kernel source changes: the stamp is
    a hash over every .cu/.cuh and the nvcc flags."""
    names = {p.name for p in _build.SOURCE_DIR.iterdir()}
    assert {"decode_attention.cu", "flash_attention.cu"} <= names
    assert len(_build.source_hash()) == 64
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
