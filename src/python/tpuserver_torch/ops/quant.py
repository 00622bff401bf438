"""Int8 weight-only quantization for serving (the port of
``tpuserver/ops/quant.py``).

Weights are stored int8 with per-output-channel symmetric scales (about
half the bytes of bf16), activations stay bf16.  The JAX package leaves
the weight-only product to XLA, which fuses the int8 -> bf16 ``convert``
into the dot so that HBM traffic is the int8 bytes.  PyTorch has no such
fusion: ``x @ q.to(x.dtype)`` writes a bf16 copy of the weight and reads
it back, 5 bytes a parameter instead of 1.  So on the card the
weight-only product is the hand-written W8A16 kernel
``csrc/int8_matmul.cu`` (:func:`int8_matmul`), which reads the int8
bytes once and converts them in registers; :func:`int8_matmul_reference`
is its plain version, which runs only for tensors on the CPU.

Quantized tensors are plain dicts ``{"q": int8 [in, out], "s": float32
[out]}``, leaves of the params tree like any other.
"""

import torch

from tpuserver_torch.ops import _build
from tpuserver_torch.ops.flash import _raise_on, _stream

# torch._int_mm (cuBLASLt) takes more than 16 rows: fewer are padded
# with zero rows to this many, which change no other row
_INT_MM_MIN_ROWS = 32
# the W8A16 kernel's tiles: 128 columns a block, up to 40 rows (five n8
# MMA tiles), K cut into splits of a multiple of 256 rows and at most 1024
# (the x rows a block stages), as many as give about 512 blocks (four an
# SM of an H100's 132), a constant so that a row's bits do not depend on
# the card
_BLOCK_N = 128
_BLOCK_M = 40
_SPLIT_ALIGN = 256
_SPLIT_MAX_ROWS = 1024
_SPLIT_TARGET_BLOCKS = 512
# each stream's zeroed ticket counters of the kernel's split tiles (every
# launch leaves them zeroed again)
_tickets = {}


def quantize_int8(w, axis=0):
    """Per-output-channel symmetric int8 quantization of a 2-D weight.

    ``axis`` is the *reduction* (input) axis: scales are computed per
    channel of the other (output) axis, so the matmul result can be
    rescaled per output column with one broadcast multiply.  Computed in
    float32 as the reference computes it (amax, ``/127``, ``max(.,
    1e-8)``, round half to even, clip to +-127).  Returns ``{"q": int8,
    "s": float32[out]}``."""
    if w.dim() != 2:
        raise ValueError(
            "quantize_int8 expects a 2-D weight, got shape {}".format(
                tuple(w.shape)))
    # |w| and its max are exact in the weight's own dtype, and the
    # division promotes to float32: no float32 copy of the weight beside
    # the quotient (a bf16 lm_head of 8B is 1 GiB)
    amax = w.abs().amax(dim=axis, keepdim=True).float()
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.div(w, scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.reshape(-1)}


def is_quantized(w):
    return isinstance(w, dict) and "q" in w and "s" in w


def matmul(x, w):
    """``x @ w`` for a plain or int8-quantized weight.

    Two quantized regimes, selected by the activation shape, exactly as
    the reference selects them:

    - few rows: the weight-only product (:func:`int8_matmul`), the
      per-channel scale applied to the accumulated result;
    - ``rows >= 8`` of a >= 3-D activation: activations quantize
      dynamically per row to int8 and the product runs int8 x int8 ->
      int32 (:func:`_w8a8_matmul`).

    The regime test applies only to >= 3-D activations, where axis -2 is
    the token axis.  For a 2-D activation (the lm_head input ``x[:, -1,
    :]`` of shape [B, D]) axis -2 is the server-side batch, and switching
    regimes with batch size would change the same request's logits
    between a quiet and a loaded server."""
    if not is_quantized(w):
        return x @ w
    if x.dim() >= 3 and x.shape[-2] >= 8:
        return _w8a8_matmul(x, w)
    return int8_matmul(x, w["q"], w["s"])


def _int8_product(xq, q):
    """Exact int8 [rows, in] x int8 [in, out] -> int32 [rows, out] through
    ``torch._int_mm`` (cuBLASLt on the card), rows padded with zeros to
    ``_INT_MM_MIN_ROWS`` when there are no more than 16."""
    rows = xq.shape[0]
    if rows <= 16:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - rows,
                                          xq.shape[1]))])
    if xq.device.type == "cuda" and (xq.shape[1] % 8 or q.shape[1] % 8):
        raise ValueError(
            "w8a8 product on the card: torch._int_mm needs in and out "
            "features that are multiples of 8 (got {} and {})".format(
                xq.shape[1], q.shape[1]))
    return torch._int_mm(xq, q)[:rows]


def _w8a8_matmul(x, w):
    """Dynamic per-row activation quantization and an int8 x int8 ->
    int32 product (exact), rescaled by (row scale x channel scale) in
    float32 before the cast back to the activation dtype.

    x: [..., rows, in]; w: {"q": int8 [in, out], "s": float32 [out]}.
    Plain tensor code: the reference computes this product outside any
    Pallas kernel (``lax.dot_general``)."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    xq = torch.div(xf, sx).round_().clamp_(-127, 127).to(torch.int8)
    lead = x.shape[:-1]
    y = _int8_product(xq.reshape(-1, x.shape[-1]), w["q"])
    y = y.reshape(*lead, y.shape[-1])
    return (y.float() * sx * w["s"]).to(x.dtype)


def gather_rows(w, idx, dtype=None):
    """Row gather (embedding lookup) from a plain or per-row-quantized
    table (``quantize_int8(w, axis=1)``: one scale per row).

    ``dtype`` is the dequantized row dtype, the model's activation dtype
    (``cfg.dtype``); it defaults to bfloat16 for callers without a
    config in hand."""
    if not is_quantized(w):
        return w[idx]
    dtype = torch.bfloat16 if dtype is None else dtype
    rows = w["q"][idx].to(dtype)
    return rows * w["s"][idx].to(dtype)[..., None]


def quantized_bytes(w):
    """Device bytes a (possibly quantized) weight leaf occupies."""
    if is_quantized(w):
        return w["q"].numel() + w["s"].numel() * 4
    return w.numel() * w.element_size()


# -- the W8A16 product -------------------------------------------------------


def int8_splits(k, n):
    """(n_split, split_rows): the W8A16 kernel's cut of K for a weight
    [k, n], from the shape alone, never from the rows, so that each
    row's sum over K runs in one order whatever the number of rows."""
    want = -(-_SPLIT_TARGET_BLOCKS // -(-n // _BLOCK_N))
    rows = -(-k // max(1, min(want, k // _SPLIT_ALIGN),
                       -(-k // _SPLIT_MAX_ROWS)))
    rows = -(-rows // _SPLIT_ALIGN) * _SPLIT_ALIGN
    return -(-k // rows), rows


def int8_scratch(m, k, n):
    """(n_split, split_rows, part_shape, n_tickets) of one W8A16 launch
    at ``m`` rows: the split from (k, n) alone; with more than one split
    a float32 partial-sum scratch ``[n_split, m, n]`` and one ticket a
    tile of 128 columns and up to ``_BLOCK_M`` rows, else neither."""
    n_split, split_rows = int8_splits(k, n)
    if n_split == 1:
        return n_split, split_rows, None, 0
    return (n_split, split_rows, (n_split, m, n),
            -(-n // _BLOCK_N) * -(-m // _BLOCK_M))


def _ticket_counters(device, need):
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < need:
        buf = _tickets[key] = torch.zeros(max(need, 4096), dtype=torch.int32,
                                          device=device)
    return buf


def int8_matmul_reference(x, q, s):
    """Plain PyTorch weight-only product: ``(x @ q.to(x.dtype)) *
    s.to(x.dtype)``, cast to ``x.dtype``, in that order of roundings.  x
    [..., in], q int8 [in, out], s float32 [out] -> [..., out]."""
    y = x @ q.to(x.dtype)
    return (y * s.to(x.dtype)).to(x.dtype)


def int8_matmul(x, q, s):
    """The weight-only product ``bf16(bf16(x @ q) * bf16(s))``: x bf16
    [..., K], q int8 [K, N] (row-major, N contiguous), s float32 [N] ->
    bf16 [..., N], the sum accumulated in float32.

    For CPU tensors the plain version runs.  On the card the W8A16 kernel
    (``csrc/int8_matmul.cu``) launches, or this raises ValueError for
    what it does not take (an activation other than bf16, a q that is
    not contiguous and 16-byte aligned); it never falls back.  Each row's
    sum over K runs in one fixed order whatever the number of rows (K's
    splits, :func:`int8_splits`, follow the weight's shape alone), so a
    row's bits do not depend on the rows beside it."""
    k, n = q.shape
    if x.shape[-1] != k or s.shape != (n,):
        raise ValueError("int8_matmul: shapes x {}, q {}, s {} do not "
                         "match".format(tuple(x.shape), tuple(q.shape),
                                        tuple(s.shape)))
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s)
    if x.device.type != "cuda" or q.device != x.device or \
            s.device != x.device:
        raise ValueError("int8_matmul: operands on {}, {}, {} (expected "
                         "one cuda device, or cpu)".format(
                             x.device, q.device, s.device))
    if x.dtype != torch.bfloat16:
        raise ValueError("int8_matmul: the kernel takes bfloat16 "
                         "activations (got {})".format(x.dtype))
    if q.dtype != torch.int8 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("int8_matmul: the kernel takes a contiguous, "
                         "16-byte aligned int8 weight")
    s = s.to(torch.float32).contiguous()
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        n_split, split_rows, part_shape, n_tickets = int8_scratch(m, k, n)
        part = tickets = None
        if part_shape is not None:
            part = torch.empty(part_shape, dtype=torch.float32,
                               device=x.device)
            tickets = _ticket_counters(x.device, n_tickets)
        rc = _build.load_library().tt_int8_matmul(
            x2.data_ptr(), x2.stride(0), q.data_ptr(), s.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), m, n, k,
            n_split, split_rows, _stream(x.device))
        _raise_on(rc, "int8_matmul")
        int8_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0


def reset_launch_counts():
    """Set the W8A16 wrapper's launch count to 0."""
    int8_matmul.launches = 0
