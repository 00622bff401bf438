"""The BERT-base ensemble, the port of ``tpuserver/models/bert.py``
(BASELINE config #4): a host tokenizer (BYTES -> INT32 ids, KIND_CPU)
feeding an encoder on the card (a bidirectional transformer, bf16,
learned positions, GELU MLP) that emits a pooled embedding, and the
ensemble that chains them (``ensemble_scheduling``; the core runs the
steps).

The encoder's numerics follow the JAX package's ``jax_fn``, where a
plain torch idiom would give another answer:

- the gather: an id below zero wraps once by the table's size and every
  id then clamps into the table, as a JAX gather does (-1 -> V-1,
  -(V+1) -> 0, V -> V-1); an out-of-range index on the card would be a
  device-side assert, which ends the process's CUDA context;
- LayerNorm without a bias: mean and variance in float32, ``rsqrt(var +
  1e-12)``, the normalized value rounded to the activation dtype and
  then multiplied by the gain in it (two roundings; ``F.layer_norm``
  with a weight rounds once);
- the scores: float32 products of the bf16 q and k (exact: a bf16
  product fits a float32), ``/ sqrt(head_dim)``, the mask bias
  ``where(mask > 0, 0, -1e9)`` and the softmax in float32; the
  probabilities rounded to the activation dtype before ``p @ v``;
- GELU in its tanh form (``jax.nn.gelu``'s default);
- the pooler: ``x[:, 0] @ pool_w`` in the activation dtype, then float32,
  then ``tanh``.

Weights are random: ``init_params(generator, device)`` draws them from a
seeded ``torch.Generator`` with the JAX package's distributions (normal
over the square root of the fan-in, rounded to bf16; LayerNorm gains of
one), ``[in, out]`` as the JAX package keeps them, and
``params_from_jax(np_tree, device)`` carries the JAX package's own draw
across.  ``pooled_logits`` is the pre-tanh test hook.  No kernel of the
port lies on this path: the JAX package computes this encoder in XLA,
not Pallas, so the port calls cuBLAS through ``torch.matmul``."""

import math
import threading
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from tpuserver_torch.core import Model, TensorSpec, TorchModel
from tpuserver_torch.models.tree import tree_from_jax, tree_leaves, tree_map
from tpuserver_torch.ops.perf import bert_encoder_flops

SEQ_LEN = 128
VOCAB = 30522  # bert-base vocab size
D_MODEL = 768
N_LAYERS = 12
N_HEADS = 12
D_FF = 3072


class BertTokenizerModel(Model):
    """TEXT (BYTES [1]) -> INPUT_IDS/ATTENTION_MASK (INT32 [SEQ_LEN]).

    Whitespace split + stable hash into the vocab (ids 1000+ so specials
    stay clear); [CLS]=101 / [SEP]=102 framing like wordpiece.  numpy on
    the host."""

    name = "bert_tokenizer"
    platform = "python"
    backend = "python"
    device_kind = "cpu"
    max_batch_size = 8
    inputs = (TensorSpec("TEXT", "BYTES", [1]),)
    outputs = (
        TensorSpec("INPUT_IDS", "INT32", [SEQ_LEN]),
        TensorSpec("ATTENTION_MASK", "INT32", [SEQ_LEN]),
    )

    def execute(self, inputs, request):
        texts = np.asarray(inputs["TEXT"]).reshape(-1)
        ids = np.zeros((len(texts), SEQ_LEN), dtype=np.int32)
        mask = np.zeros((len(texts), SEQ_LEN), dtype=np.int32)
        for row, raw in enumerate(texts):
            text = raw.decode("utf-8") if isinstance(raw, bytes) else str(raw)
            tokens = [101]  # [CLS]
            for word in text.lower().split():
                tokens.append(
                    1000 + (zlib.crc32(word.encode("utf-8")) % (VOCAB - 1100)))
                if len(tokens) >= SEQ_LEN - 1:
                    break
            tokens.append(102)  # [SEP]
            ids[row, :len(tokens)] = tokens
            mask[row, :len(tokens)] = 1
        batched = np.asarray(inputs["TEXT"]).ndim > 1
        if not batched:
            return {"INPUT_IDS": ids[0], "ATTENTION_MASK": mask[0]}
        return {"INPUT_IDS": ids, "ATTENTION_MASK": mask}


def clamp_ids(ids, vocab):
    """JAX's gather index: one wrap of a negative id, then a clamp into
    ``[0, vocab - 1]``."""
    return torch.where(ids < 0, ids + vocab, ids).clamp_(0, vocab - 1)


def layer_norm(x, g):
    """Bias-free LayerNorm, eps 1e-12: statistics in float32, the
    normalized value rounded to ``x``'s dtype, then times the gain."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-12)).to(x.dtype) * g


class BertEncoderModel(TorchModel):
    """INPUT_IDS/ATTENTION_MASK -> POOLED [D_MODEL] (the CLS token's tanh
    head), bf16 on the card.  Up to 8 rows a request and no dynamic
    batching, as in the JAX package."""

    name = "bert_encoder"
    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 8
    inputs = (
        TensorSpec("INPUT_IDS", "INT32", [SEQ_LEN]),
        TensorSpec("ATTENTION_MASK", "INT32", [SEQ_LEN]),
    )
    outputs = (TensorSpec("POOLED", "FP32", [D_MODEL]),)

    def __init__(self, device=None, seed=0, params=None,
                 dtype=torch.bfloat16):
        """``params``: the port's tree (``init_params`` or
        ``params_from_jax``) to serve, moved to ``device``; None draws
        one from ``seed`` at first use.  ``dtype`` is the weights' and
        activations'."""
        super().__init__(device)
        self.dtype = dtype
        self._seed = seed
        self._params = None if params is None else tree_map(
            lambda t: t.to(self.device), params)
        # the requests of one gRPC stream run in threads of their own, so
        # the first ones can arrive together
        self._params_lock = threading.Lock()

    @staticmethod
    def init_params(generator, device, dtype=torch.bfloat16):
        """The JAX package's distributions, drawn from ``generator`` in
        its order (each layer's wq, wk, wv, wo, w_in, w_out, then the
        token table, the positions and the pooler)."""
        def dense(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
            return (w / math.sqrt(fan_in)).to(dtype)

        def ones():
            return torch.ones((D_MODEL,), dtype=dtype, device=device)

        layers = []
        for _ in range(N_LAYERS):
            layers.append({
                "wq": dense((D_MODEL, D_MODEL), D_MODEL),
                "wk": dense((D_MODEL, D_MODEL), D_MODEL),
                "wv": dense((D_MODEL, D_MODEL), D_MODEL),
                "wo": dense((D_MODEL, D_MODEL), D_MODEL),
                "ln1": ones(),
                "w_in": dense((D_MODEL, D_FF), D_MODEL),
                "w_out": dense((D_FF, D_MODEL), D_FF),
                "ln2": ones(),
            })
        return {"tok_embed": dense((VOCAB, D_MODEL), D_MODEL),
                "pos_embed": dense((SEQ_LEN, D_MODEL), D_MODEL),
                "layers": layers,
                "pool_w": dense((D_MODEL, D_MODEL), D_MODEL)}

    @staticmethod
    def params_from_jax(np_tree, device):
        """The JAX package's parameter tree (``_get_params()`` with
        ``jax.tree_util.tree_map(np.asarray, ...)``) as the port's."""
        return tree_from_jax(np_tree, device)

    def params(self):
        if self._params is None:
            with self._params_lock:
                if self._params is None:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(self._seed)
                    self._params = self.init_params(gen, self.device,
                                                    self.dtype)
        return self._params

    @staticmethod
    def apply(params, ids, mask):
        """The pre-tanh pooler output [B, D] in float32 of ``ids`` and
        ``mask`` [B, T]."""
        b, t = ids.shape
        table = params["tok_embed"]
        x = table[clamp_ids(ids, table.shape[0]).long()] + \
            params["pos_embed"][:t]
        d = x.shape[-1]
        hd = d // N_HEADS
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(
            torch.float32)

        def heads(y):
            return y.view(b, t, N_HEADS, hd).transpose(1, 2)

        for layer in params["layers"]:
            h = layer_norm(x, layer["ln1"])
            q, k, v = (heads(h @ layer[w]) for w in ("wq", "wk", "wv"))
            s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
            p = torch.softmax(s + bias, dim=-1)
            attn = (p.to(x.dtype) @ v).transpose(1, 2).reshape(b, t, d)
            x = x + attn @ layer["wo"]
            h = layer_norm(x, layer["ln2"])
            x = x + F.gelu(h @ layer["w_in"], approximate="tanh") @ \
                layer["w_out"]
        return (x[:, 0, :] @ params["pool_w"]).float()

    def pooled_logits(self, ids, mask, params=None):
        """The pooler's output before its tanh, float32: [D] for a 1-D
        request, [B, D] for a batch (``params`` default: the served
        weights)."""
        params = self.params() if params is None else params
        if ids.ndim == 1:
            return self.apply(params, ids[None], mask[None])[0]
        return self.apply(params, ids, mask)

    def forward(self, INPUT_IDS, ATTENTION_MASK):
        return {"POOLED": torch.tanh(
            self.pooled_logits(INPUT_IDS, ATTENTION_MASK))}

    def warmup(self):
        """Batch 1 and batch 8 once, on the calling thread."""
        for b in (1, self.max_batch_size):
            self.execute({"INPUT_IDS": np.zeros((b, SEQ_LEN), np.int32),
                          "ATTENTION_MASK": np.ones((b, SEQ_LEN), np.int32)},
                         None)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def operations(self, batch):
        """The forward's FLOPs at ``batch`` rows of SEQ_LEN tokens
        (``ops.perf.bert_encoder_flops`` is one sequence's)."""
        return batch * bert_encoder_flops(SEQ_LEN, D_MODEL, N_LAYERS, D_FF)

    def weight_bytes(self):
        """The bytes of the weights a forward reads whole: every leaf but
        the token table, of which it gathers one row a token."""
        params = self.params()
        return sum(t.numel() * t.element_size() for t in tree_leaves(
            {k: v for k, v in params.items() if k != "tok_embed"}))


class BertEnsembleModel(Model):
    """TEXT -> POOLED via tokenizer + encoder (ensemble_scheduling steps,
    the shape the reference's perf_analyzer calls ENSEMBLE)."""

    name = "bert_ensemble"
    platform = "ensemble"
    backend = ""
    max_batch_size = 8
    inputs = (TensorSpec("TEXT", "BYTES", [1]),)
    outputs = (TensorSpec("POOLED", "FP32", [D_MODEL]),)
    ensemble_steps = [
        {
            "model_name": "bert_tokenizer",
            "model_version": -1,
            "input_map": {"TEXT": "TEXT"},
            "output_map": {
                "INPUT_IDS": "ids",
                "ATTENTION_MASK": "mask",
            },
        },
        {
            "model_name": "bert_encoder",
            "model_version": -1,
            "input_map": {"INPUT_IDS": "ids", "ATTENTION_MASK": "mask"},
            "output_map": {"POOLED": "POOLED"},
        },
    ]


def bert_models(device=None, seed=0):
    """The tokenizer, the encoder on ``device`` (weights drawn from
    ``seed``) and the ensemble."""
    return [BertTokenizerModel(), BertEncoderModel(device=device, seed=seed),
            BertEnsembleModel()]
