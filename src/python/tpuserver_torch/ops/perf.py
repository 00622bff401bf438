"""Roofline accounting for the llama serving path (the port of
``tpuserver/ops/perf.py``): analytic FLOP and byte counts per config,
and a table of card specs, so that a run can report MFU (achieved FLOP/s
over the card's peak) and MBU (achieved device-memory bytes/s over its
peak bandwidth) beside bare tokens/s.

Peaks are the published per-card specs (NVIDIA's data sheet: dense bf16
tensor-core rate and HBM bandwidth, at the card's full power limit).  MFU
counts only algorithmic matmul and attention FLOPs (2*m*n*k a matmul).
The counters read the port's ``LlamaConfig``.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float  # FLOP/s
    hbm_bandwidth: float    # bytes/s
    hbm_bytes: int


# published single-card specs, keyed by torch.cuda.get_device_name
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": ChipSpec("h100-sxm", 989e12, 3.35e12, 80 << 30),
}


def chip_spec(device=None):
    """Spec for the CUDA ``device`` (default: the current card), or None
    on the CPU, without a card, or for a card the table does not know."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return CHIP_SPECS.get(torch.cuda.get_device_name(device))


def param_count(cfg):
    """Analytic parameter count of ``llama.init_params`` for ``cfg``."""
    hd = cfg.head_dim
    per_layer = (
        cfg.d_model * cfg.n_heads * hd          # wq
        + 2 * cfg.d_model * cfg.n_kv_heads * hd  # wk, wv
        + cfg.n_heads * hd * cfg.d_model        # wo
        + 3 * cfg.d_model * cfg.d_ff            # gate, up, down
        + 2 * cfg.d_model                       # norms
    )
    return (
        2 * cfg.vocab * cfg.d_model             # embed + lm_head
        + cfg.n_layers * per_layer
        + cfg.d_model                           # final norm
    )


def matmul_params(cfg):
    """Params that take part in per-token matmuls (excludes the embed
    gather, which costs a lookup, not FLOPs; includes lm_head)."""
    return param_count(cfg) - cfg.vocab * cfg.d_model


def decode_flops_per_token(cfg, ctx_len):
    """Forward FLOPs to decode ONE token at context length ``ctx_len``:
    2 FLOPs per matmul parameter, plus attention (per layer the single
    query attends over ``ctx_len`` cached K/V rows; QK^T and PV are each
    2 * ctx_len * n_heads * head_dim FLOPs)."""
    attn = cfg.n_layers * 4 * ctx_len * cfg.n_heads * cfg.head_dim
    return 2 * matmul_params(cfg) + attn


def prefill_flops(cfg, seq_len):
    """Forward FLOPs of a causal prefill of ``seq_len`` tokens: matmuls
    linear in tokens; causal attention sums to about seq_len^2/2 score
    rows per head per layer (QK^T + PV)."""
    matmul = 2 * matmul_params(cfg) * seq_len
    attn = cfg.n_layers * 4 * (seq_len * seq_len // 2) * (
        cfg.n_heads * cfg.head_dim
    )
    return matmul + attn


def decode_bytes_per_token(cfg, ctx_len, dtype_bytes=2,
                           weight_bytes_per_param=None):
    """Device-memory bytes touched to decode one token: every matmul
    weight is read once, the valid KV prefix is read, and one KV row is
    written.  ``weight_bytes_per_param`` overrides the weight-read cost
    (1 for int8-quantized serving; KV stays ``dtype_bytes``)."""
    wb = (
        weight_bytes_per_param
        if weight_bytes_per_param is not None
        else dtype_bytes
    )
    weights = matmul_params(cfg) * wb
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    kv = cfg.n_layers * kv_row * (ctx_len + 1)
    return weights + kv


def bert_encoder_flops(seq_len=128, d_model=768, n_layers=12, d_ff=3072):
    """Forward FLOPs of one BERT-base-shaped encoder pass: per layer 4
    attention projections and the 2 MLP matmuls (2*m*n*k each) and
    QK^T/PV attention, plus the pooler."""
    per_layer = (
        2 * seq_len * (4 * d_model * d_model + 2 * d_model * d_ff)
        + 4 * seq_len * seq_len * d_model
    )
    return n_layers * per_layer + 2 * d_model * d_model


def mfu(flops, seconds, spec):
    """Achieved-over-peak FLOP ratio (None without a known card)."""
    if spec is None or seconds <= 0:
        return None
    return flops / seconds / spec.peak_bf16_flops


def mbu(nbytes, seconds, spec):
    """Achieved-over-peak device-memory bandwidth ratio."""
    if spec is None or seconds <= 0:
        return None
    return nbytes / seconds / spec.hbm_bandwidth
