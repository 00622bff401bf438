"""The port's llama model (tpuserver_torch.models.llama) held against the
JAX package's (tpuserver.models.llama) on the CPU, with the same weights:
``llama.init_params(PRNGKey(...))`` bridged by ``params_from_jax``.

Tolerances: 1e-4 on float32 logits (both sides compute in float32, in
another order); 5e-2 on bfloat16 logits.  Greedy tokens must be
identical on float32 ``tiny``, on a prompt length the flash path takes
and on one the dense path takes."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.models import llama as jl
from tpuserver_torch.models import llama as tl

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _configs(dtype, vocab=256, **port_kw):
    jcfg = dataclasses.replace(
        jl.tiny(vocab=vocab), dtype=jnp.float32 if dtype == "float32"
        else jnp.bfloat16)
    tcfg = dataclasses.replace(
        tl.tiny(vocab=vocab), dtype=torch.float32 if dtype == "float32"
        else torch.bfloat16, **port_kw)
    return jcfg, tcfg


def _bridged(jcfg, seed=0):
    params = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, tl.params_from_jax(np_params, CPU)


def _np(t):
    return t.detach().float().numpy()


def test_params_from_jax_is_bit_exact_in_bf16():
    jcfg, _ = _configs("bfloat16")
    params, tparams = _bridged(jcfg)
    a = np.asarray(params["layers"][1]["wq"]).view(np.uint16)
    b = tparams["layers"][1]["wq"]
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
    np.testing.assert_array_equal(b.view(torch.int16).numpy().view(
        np.uint16), a)
    assert len(tparams["layers"]) == jcfg.n_layers
    assert set(tparams) == {"embed", "layers", "norm", "lm_head"}


def test_init_params_shapes_and_seed():
    cfg = dataclasses.replace(tl.tiny(), dtype=torch.float32)
    a = tl.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    b = tl.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    jparams = jl.init_params(jax.random.PRNGKey(0), jl.tiny())
    for name in ("embed", "lm_head", "norm"):
        assert tuple(a[name].shape) == tuple(jparams[name].shape)
        assert torch.equal(a[name], b[name])
    for key, w in jparams["layers"][0].items():
        assert tuple(a["layers"][0][key].shape) == tuple(w.shape), key
    # normal / sqrt(fan_in), as the JAX init draws it
    std = a["layers"][0]["w_gate"].std().item()
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.02


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    ref = jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("positions_2d", [False, True])
def test_rope_matches_jax(positions_2d):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = np.arange(3, 10)
    if positions_2d:
        pos = np.stack([pos, pos + 100])
    ref = jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_block_matches_jax():
    jcfg, tcfg = _configs("float32")
    params, tparams = _bridged(jcfg)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, jcfg.d_model).astype(np.float32)
    n_rep = jcfg.n_heads // jcfg.n_kv_heads

    def jattn(q, k, v):
        from tpuserver.parallel.ring import ring_attention

        return ring_attention(q, jl._expand_kv(k, n_rep),
                              jl._expand_kv(v, n_rep), causal=True)

    ref = jl._block(params["layers"][0], jnp.asarray(x), jnp.arange(16),
                    jcfg, jattn)
    out = tl._block(tparams["layers"][0], torch.from_numpy(x),
                    torch.arange(16), tcfg,
                    lambda q, k, v: tl._dense_causal(q, k, v, n_rep))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("T,attn_impl", [(32, "dense"), (128, "kernel")])
def test_forward_matches_jax(T, attn_impl):
    """Dense at T=32; at T=128 the port takes its flash path (plain
    version on the CPU, GQA native) against JAX's dense attention."""
    jcfg, tcfg = _configs("float32", attn_impl=attn_impl)
    params, tparams = _bridged(jcfg)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab, (2, T))
    ref = jl.forward(params, jnp.asarray(tokens, jnp.int32), jcfg)
    out = tl.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_flash_blocks_gate_matches_jax():
    jcfg, tcfg = jl.llama3_8b(), tl.llama3_8b()
    for T in (1, 64, 77, 128, 192, 256, 384, 512, 640, 1024, 2048, 4000):
        assert tl._flash_blocks(T, tcfg) == jl._flash_blocks(T, jcfg), T


def _generate_jax(jcfg, params, prompt, max_seq, n=12, chunk=4):
    prefill = jax.jit(functools.partial(jl.prefill, cfg=jcfg))
    decode = jax.jit(functools.partial(jl.decode_chunk, cfg=jcfg,
                                       chunk=chunk))
    cache = jl.init_kv_cache(jcfg, 1, max_seq)
    logits, cache = prefill(params, cache, jnp.asarray(prompt)[None, :])
    first = np.asarray(logits)
    out, pos = [], len(prompt)
    for _ in range(n // chunk):
        toks, _, logits, cache = decode(params, cache, logits, pos)
        out.append(np.asarray(toks)[:, 0])
        pos += chunk
    return first, np.concatenate(out), np.asarray(logits)


def _generate_port(tcfg, tparams, prompt, max_seq, n=12, chunk=4):
    cache = tl.init_kv_cache(tcfg, 1, max_seq, CPU)
    logits, cache = tl.prefill(tparams, cache,
                               torch.from_numpy(prompt)[None, :], tcfg)
    first = _np(logits)
    out, pos = [], len(prompt)
    for _ in range(n // chunk):
        toks, _, logits, cache = tl.decode_chunk(tparams, cache, logits, pos,
                                                 tcfg, chunk)
        out.append(toks[:, 0].numpy())
        pos += chunk
    return first, np.concatenate(out), _np(logits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt_len", [128, 77],
                         ids=["flash_prefill", "dense_prefill"])
def test_prefill_decode_matches_jax(prompt_len, dtype):
    """Prefill + chunked greedy decode with both sides' kernels wired in
    (JAX: Pallas interpret mode; the port: its kernels' plain versions
    on the CPU), max_seq 256.  Greedy tokens identical for 12 tokens."""
    jcfg, tcfg = _configs(dtype, vocab=128, attn_impl="kernel")
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas",
                               decode_impl="pallas")
    assert (jl._flash_blocks(prompt_len, jcfg)[0] is not None) == (
        prompt_len == 128)
    params, tparams = _bridged(jcfg, seed=5)
    prompt = np.random.RandomState(9).randint(0, 128, prompt_len).astype(
        np.int64)
    j_first, j_toks, j_last = _generate_jax(jcfg, params, prompt, 256)
    t_first, t_toks, t_last = _generate_port(tcfg, tparams, prompt, 256)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(t_first, j_first, rtol=tol, atol=tol)
    np.testing.assert_array_equal(t_toks, j_toks)
    np.testing.assert_allclose(t_last, j_last, rtol=tol, atol=tol)


def test_run_cached_writes_cache_in_place():
    _, tcfg = _configs("float32")
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    cache = tl.init_kv_cache(tcfg, 1, 128, CPU)
    ptr = cache.data_ptr()
    _, out = tl.prefill(params, cache, torch.arange(10)[None, :], tcfg)
    assert out is cache and cache.data_ptr() == ptr
    assert cache[:, :, :, :10].abs().sum() > 0
    assert not cache[:, :, :, 10:].any()
    _, out = tl.decode_step(params, cache, torch.tensor([3]), 10, tcfg)
    assert out is cache and cache[:, :, :, 10].abs().sum() > 0
