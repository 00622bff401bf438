"""SPMD training of the port on the CPU (the counterpart of the training
half of ``tests/test_llama.py``): ``ring_attention``,
``ulysses_attention``, ``sharded_forward`` and ``make_train_step`` over
four gloo ranks, held against the JAX package on its 8-device virtual
CPU mesh.

Four ranks are spawned once for the module (``torch_train_ranks.
RankPool``, which imports no JAX); each runs every task on its own, as
every rank of a training mesh runs its own loop.  The JAX side runs its
``shard_map`` programs on the first four virtual devices.

Weights: ``tiny(vocab=128)``, ``init_params(PRNGKey(0))`` of the JAX
package bridged by ``params_from_jax``; tokens from a numpy seed.
Tolerances, float32: attention outputs and input gradients, and logits,
within 1e-5 (the same math, summed in other orders); every leaf's
gradient within 1e-4 of JAX's unsharded gradient in relative norm (JAX's
own sharded gradients agree with it to 1e-6); three AdamW steps' losses
within 1e-4 of JAX's.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_train_ranks as ranks
from tpuserver.models import llama as jl
from tpuserver.parallel import MeshConfig as JaxMeshConfig
from tpuserver.parallel import make_mesh as jax_make_mesh
from tpuserver.parallel.ring import ring_attention as jax_ring
from tpuserver.parallel.ulysses import ulysses_attention as jax_ulysses
from tpuserver_torch.models import llama as tl
from tpuserver_torch.parallel import ring_attention, ulysses_attention

pytestmark = pytest.mark.torch_port

VOCAB = 128
WORLD = 4
B, T = 2, 16
MESHES = [(1, 1, 4), (1, 2, 2), (2, 1, 2), (1, 4, 1)]
ATOL = 1e-5
GRAD_RTOL = 1e-4
LOSS_TOL = 1e-4
LR = 1e-2
STEPS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = ranks.RankPool(WORLD, str(tmp_path_factory.mktemp("train") / "st"))
    yield p
    codes = p.close()
    torch.set_num_threads(threads)
    assert codes == [0] * WORLD


def _jcfg(dtype=jnp.float32, strategy="ring"):
    return dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=dtype,
                               sp_strategy=strategy)


@pytest.fixture(scope="module")
def setup():
    """(JAX params, their numpy tree, tokens, targets)."""
    params = jl.init_params(jax.random.PRNGKey(0), _jcfg())
    tok = ranks.random_tokens(3, B, T, VOCAB)
    return (params, jax.tree_util.tree_map(np.asarray, params),
            tok[:, :-1], tok[:, 1:])


def _mean_nll(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, targets[..., None], axis=-1))


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's unsharded gradient of the mean next-token loss, by leaf
    path."""
    params, _, tokens, targets = setup
    cfg = _jcfg()
    grads = jax.jit(jax.grad(lambda p: _mean_nll(
        jl.forward(p, jnp.asarray(tokens), cfg), jnp.asarray(targets))))(
        params)
    return _by_path(grads)


def _by_path(tree):
    out = {"embed": np.asarray(tree["embed"]),
           "norm": np.asarray(tree["norm"]),
           "lm_head": np.asarray(tree["lm_head"])}
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            out["layers.{}.{}".format(i, k)] = np.asarray(v)
    return out


def _spec(path):
    """The tp shard dim of a leaf path (``llama.param_specs``)."""
    specs = tl.param_specs(tl.tiny(vocab=VOCAB))
    if path.startswith("layers."):
        _, i, name = path.split(".")
        return specs["layers"][int(i)][name]
    return specs[path]


def _slice(full, path, tp, t):
    dim = _spec(path)
    return full if dim is None or tp == 1 else np.split(full, tp, dim)[t]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_mesh(shape):
    return jax_make_mesh(JaxMeshConfig(*shape), jax.devices()[:WORLD])


# -- the two sequence-parallel attentions ------------------------------------


def _qkv(strategy):
    """Seeded q [2, 16, 8, 8] and k, v (8 heads for ring; 4 kv heads,
    repeated 2x, for Ulysses), and an output cotangent."""
    rng = np.random.RandomState(5)
    hkv = 8 if strategy == "ring" else 4
    q = rng.randn(B, T, 8, 8).astype(np.float32)
    k = rng.randn(B, T, hkv, 8).astype(np.float32)
    v = rng.randn(B, T, hkv, 8).astype(np.float32)
    g = rng.randn(B, T, 8, 8).astype(np.float32)
    return q, k, v, g, 8 // hkv


def _jax_attention(strategy, sp, q, k, v, g, rep):
    """JAX's output and input gradients (vjp with cotangent ``g``), at
    ``axis_name=None`` (sp None) or under ``shard_map`` over sp devices."""
    def attn(q, k, v, axis_name=None):
        if strategy == "ring":
            return jax_ring(q, k, v, axis_name=axis_name)
        return jax_ulysses(q, k, v, axis_name=axis_name, kv_repeat=rep)

    fn = attn
    if sp is not None:
        fn = shard_map(
            lambda q, k, v: attn(q, k, v, axis_name="sp"),
            mesh=jax_make_mesh(JaxMeshConfig(dp=1, sp=sp, tp=1),
                               jax.devices()[:sp]),
            in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
            check_vma=False)
    out, vjp = jax.vjp(jax.jit(fn), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    return [np.asarray(a) for a in (out,) + vjp(jnp.asarray(g))]


@pytest.mark.parametrize("sp", [None, 2, 4])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_attention_and_its_gradients_match_jax(pool, strategy, sp):
    """Output and the gradients of q, k and v within 1e-5 of JAX's, at
    ``axis=None`` in this process and sharded over sp = 2 and 4 ranks."""
    q, k, v, g, rep = _qkv(strategy)
    want = _jax_attention(strategy, sp, q, k, v, g, rep)
    if sp is None:
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = (ring_attention(*ts) if strategy == "ring"
               else ulysses_attention(*ts, kv_repeat=rep))
        (out * torch.from_numpy(g)).sum().backward()
        got = [out.detach().numpy()] + [t.grad.numpy() for t in ts]
    else:
        per = pool.run(ranks.attention, strategy, sp, q, k, v, g, rep)
        # a rank's block is its sp coordinate's: rank // 1 % sp in (4/sp,
        # sp, 1); the first sp ranks hold the blocks in order
        got = [np.concatenate([per[r][i] for r in range(sp)], axis=1)
               for i in range(4)]
        for r in range(sp, WORLD):  # the other dp replicas agree
            for a, b in zip(per[r], per[r % sp]):
                np.testing.assert_array_equal(a, b)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("heads,kv_heads,rep", [(6, 6, 1), (8, 1, 2)])
def test_ulysses_value_errors_are_jax_s(pool, heads, kv_heads, rep):
    """Heads not divisible by sp, and kv heads times kv_repeat not
    divisible by sp: the same ValueError as JAX's, word for word."""
    q = np.zeros((1, 8, heads, 8), np.float32)
    kv = np.zeros((1, 8, kv_heads, 8), np.float32)
    fn = shard_map(
        lambda q, k, v: jax_ulysses(q, k, v, axis_name="sp", kv_repeat=rep),
        mesh=jax_make_mesh(JaxMeshConfig(dp=1, sp=4, tp=1),
                           jax.devices()[:4]),
        in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
        check_vma=False)
    with pytest.raises(ValueError) as err:
        jax.jit(fn)(q, kv, kv)
    got = pool.run(ranks.ulysses_error, heads, kv_heads, rep)
    assert got == [str(err.value)] * WORLD


# -- sharded_forward and the gradients ---------------------------------------


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_forward_and_gradients_match_jax(pool, setup, jax_grads,
                                                 shape, strategy):
    """Each rank's logits block within 1e-5 of JAX's ``sharded_forward``
    at the same mesh; the loss JAX's unsharded loss; every leaf's summed
    gradient within 1e-4 (relative norm) of the matching slice of JAX's
    unsharded gradient, on every rank."""
    params, full, tokens, targets = setup
    cfg = _jcfg(strategy=strategy)
    want = np.asarray(jax.jit(jl.sharded_forward(_jax_mesh(shape), cfg))(
        params, jnp.asarray(tokens)))
    loss = float(_mean_nll(jl.forward(params, jnp.asarray(tokens), cfg),
                           jnp.asarray(targets)))
    dp, sp, tp = shape
    for (d, s, t), logits, got_loss, grads in pool.run(
            ranks.forward_and_grads, shape, strategy, full, tokens,
            targets):
        block = want[d * B // dp:(d + 1) * B // dp,
                     s * T // sp:(s + 1) * T // sp]
        np.testing.assert_allclose(logits, block, atol=ATOL, rtol=0)
        assert abs(got_loss - loss) < LOSS_TOL
        assert set(grads) == set(jax_grads)
        for path, g in grads.items():
            assert _rel(g, _slice(jax_grads[path], path, tp, t)) \
                <= GRAD_RTOL, (path, d, s, t)


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)])
def test_planted_fault_moves_the_gradients_past_the_limit(pool, setup,
                                                          jax_grads, shape):
    """Layer 0's ``copy_to_tp`` without its backward sum over tp: the
    gradients upstream of it (layer 0's norms, the embedding) miss the
    other tp ranks' shares, far beyond the 1e-4 limit."""
    _, full, tokens, targets = setup
    worst = 0.0
    for (_, _, t), _, _, grads in pool.run(
            ranks.forward_and_grads, shape, "ring", full, tokens, targets,
            0):
        worst = max(worst, max(
            _rel(g, _slice(jax_grads[p], p, shape[2], t))
            for p, g in grads.items()))
    assert worst > 100 * GRAD_RTOL


# -- make_train_step ---------------------------------------------------------


def _jax_train(setup, dtype, shape=(1, 2, 2)):
    params, _, tokens, targets = setup
    cfg = _jcfg(dtype)
    step_fn, init_fn = jl.make_train_step(_jax_mesh(shape), cfg,
                                          learning_rate=LR)
    p, opt = init_fn(jax.random.PRNGKey(0), tokens)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = step_fn(p, opt, jnp.asarray(tokens),
                               jnp.asarray(targets))
        losses.append(float(loss))
    return losses, _by_path(jax.tree_util.tree_map(np.asarray, p))


def test_train_steps_match_jax(pool, setup):
    """Three AdamW steps (lr 1e-2) at (1, 2, 2), float32: the losses
    within 1e-4 of JAX's, the same on every rank, and falling.  The
    params after them: within 1e-4 in relative norm over each leaf, and
    no element further than 6 lr from JAX's, since Adam's normalized
    step moves an element by about lr whatever its gradient's size, so
    an element whose tiny gradient takes the other sign in the other
    summation order may step the other way on each of the three
    steps."""
    _, full, tokens, targets = setup
    want_losses, want_params = _jax_train(setup, jnp.float32)
    for (_, _, t), losses, params in pool.run(
            ranks.train, (1, 2, 2), "ring", "float32", full, tokens,
            targets, LR, STEPS):
        np.testing.assert_allclose(losses, want_losses, atol=LOSS_TOL,
                                   rtol=0)
        assert losses[-1] < losses[0]
        for path, p in params.items():
            ref = _slice(want_params[path], path, 2, t)
            assert _rel(p, ref) <= 1e-4, path
            assert np.abs(p - ref).max() <= 6 * LR, path


def test_bf16_train_steps_fall_near_jax(pool, setup):
    """bfloat16 at (1, 2, 2), ring and Ulysses: the losses within 2e-2 of
    JAX's bf16 losses (both round every product and sum to bf16, in other
    orders, and the params' rounding feeds the next step), falling, and
    ring within JAX's own 5e-3 of Ulysses."""
    _, full, tokens, targets = setup
    want, _ = _jax_train(setup, jnp.bfloat16)
    got = {}
    for strategy in ("ring", "ulysses"):
        per = pool.run(ranks.train, (1, 2, 2), strategy, "bfloat16", full,
                       tokens, targets, LR, STEPS)
        got[strategy] = per[0][1]
        assert all(r[1] == got[strategy] for r in per)
        np.testing.assert_allclose(got[strategy], want, atol=2e-2, rtol=0)
        assert got[strategy][-1] < got[strategy][0]
    assert abs(got["ring"][0] - got["ulysses"][0]) < 5e-3


def test_sharded_forward_raises_jax_s_errors(setup):
    """An unknown sp strategy, and tp not dividing the heads, raise JAX's
    ValueErrors."""
    params, _, tokens, _ = setup
    jcfg = _jcfg(strategy="zigzag")
    with pytest.raises(ValueError) as err:
        jax.jit(jl.sharded_forward(_jax_mesh((1, 2, 2)), jcfg))(
            params, jnp.asarray(tokens))
    tcfg = dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32,
                               sp_strategy="zigzag")
    ctx = _OneRank()
    with pytest.raises(ValueError) as ours:
        tl._forward_spmd({}, torch.zeros(1, 4, dtype=torch.long), tcfg, ctx)
    assert str(ours.value) == str(err.value)
    bad = dataclasses.replace(tcfg, n_heads=6, n_kv_heads=3)
    ctx.tp.size = 4
    with pytest.raises(ValueError, match="tp=4 must divide n_heads=6"):
        tl._forward_spmd({}, torch.zeros(1, 4, dtype=torch.long), bad, ctx)


class _Axis:
    def __init__(self, name):
        self.name, self.size, self.rank = name, 1, 0


class _OneRank:
    """A ``MeshContext`` of one rank, for the errors raised before any
    collective."""

    def __init__(self):
        self.tp, self.sp, self.dpsp = (_Axis("tp"), _Axis("sp"),
                                       _Axis("dpsp"))
        self.faults = {}


# -- the serving path --------------------------------------------------------


def test_serving_never_enters_the_training_hooks(monkeypatch, setup):
    """Serving passes ``enter=None``: its prefill and decode step call no
    differentiable collective, and their logits are the same bits with
    the training hooks made to raise."""
    _, full, tokens, _ = setup
    cfg = dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32)
    params = tl.params_from_jax(full, "cpu")
    prompt = torch.from_numpy(tokens[:1].astype(np.int64))

    def run():
        cache = tl.init_kv_cache(cfg, 1, 32, "cpu")
        first, cache = tl.prefill(params, cache, prompt, cfg)
        nxt, _ = tl.decode_step(params, cache, first.argmax(-1), T, cfg)
        return first, nxt

    want = run()

    def refuse(*args, **kwargs):
        raise AssertionError("serving entered a training hook")

    for name in ("copy_to_tp", "reduce_from_tp", "gather_from_tp"):
        monkeypatch.setattr(tl, name, refuse)
    for a, b in zip(run(), want):
        assert torch.equal(a, b)


def test_training_modules_import_no_jax():
    code = ("import sys; import tpuserver_torch.parallel, "
            "tpuserver_torch.parallel.collectives, "
            "tpuserver_torch.parallel.ring, "
            "tpuserver_torch.parallel.ulysses, "
            "tpuserver_torch.models.llama; "
            "from tpuserver_torch.parallel import ring_attention, "
            "ulysses_attention; "
            "from tpuserver_torch.models.llama import sharded_forward, "
            "_forward_spmd, make_train_step; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tpuserver.', 'tritonclient'))]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python")),
        timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
