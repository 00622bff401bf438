"""The port's attention kernels against their plain fallbacks on the card.

    PYTHONPATH=src/python python -m tpuserver_torch.bench_kernels [--quick]
        [--device cpu]

The port's counterpart of the JAX package's kernel sweep: times the flash
kernel (``tpuserver_torch.ops.flash_attention``, CUDA) against the dense
float32 softmax(QK^T)V at serving sequence lengths, and the decode kernel
(``decode_attention``) against the padded-cache dense decode at serving
KV lengths: the two hot ops of the llama path.  Prints one JSON line per
(op, shape, impl) and one speedup line per shape, with the JAX tool's
keys; ``impl`` is ``torch_dense``, ``cuda_flash`` or ``cuda_decode`` and
the speedup's key ``kernel_speedup``.

Measurement: the counterpart of the JAX tool's ``lax.scan`` inside one
dispatch is a CUDA graph of the n-long chain (each call consumes the
previous output), replayed between two host fences; two chain lengths are
differenced, which cancels the fixed cost of a replay and its fence.
Every round copies fresh input values into the graph's static input.  The
chain keeps K and V (and at T 2048 Q too) resident in the card's 50 MB
L2: these are warm-cache times.  On the CPU (``--device cpu``) the chain
is a plain loop and the kernels' plain versions run.

Each impl runs in its own ``try``: a dense arm that fails (at T 32768
its scores alone are 64 GiB of float32) prints the error line on stderr,
the kernel's row still prints, and the speedup line is left out.

A graph replay launches the kernels without their wrappers, whose counts
move only when a chain is captured.  ``LAUNCHES`` keeps both numbers by
wrapper name: ``counted``, what the wrapper counted (the eager warm-up
calls and the calls captured into graphs; each graph must have captured
one launch a call of its chain), and ``replayed``, each replay's
captured launches summed (derived, not counted by the wrapper).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpuserver_torch import resolve_device
from tpuserver_torch.ops import decode_attention, flash_attention, perf

#: the kernel launches of the last :func:`main` (or bench call) on the
#: card, by wrapper name: ``counted`` by the wrapper (eager calls and
#: captures) and ``replayed`` (the captured launches times the replays)
LAUNCHES = {name: {"counted": 0, "replayed": 0}
            for name in ("flash_attention", "decode_attention")}


def _dense_attn(q, k, v, causal=True):
    """The plain fallback: one softmax(QK^T)V in float32 (plain torch
    ops, the JAX tool's XLA arm; no fused library attention)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(
        q.shape[-1])
    if causal:
        t = q.shape[1]
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        s = torch.where((cols <= rows)[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _dense_decode(q, kc, vc, length):
    """Plain fallback for single-query decode over a padded cache."""
    n_rep = q.shape[1] // kc.shape[2]
    k = kc.repeat_interleave(n_rep, dim=2).float()
    v = vc.repeat_interleave(n_rep, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) / np.sqrt(q.shape[-1])
    mask = (torch.arange(kc.shape[1], device=q.device)[None, None, :]
            < length[:, None, None])
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)


def _fence(x):
    """Wait for ``x`` by fetching two of its values to the host."""
    x.reshape(-1)[:2].cpu()


def _chain(step, x, n):
    for _ in range(n):
        x = step(x)
    return x


def _time_scanned(step, make_input, n_lo, n_hi, repeats=3, kernel=None):
    """Per-call seconds for ``step`` (x -> x-shaped output), measured as
    the n-long chain of calls at two lengths and differenced: (t(n_hi) -
    t(n_lo)) / (n_hi - n_lo), the best of ``repeats`` rounds.  On the
    card each chain is one CUDA graph (the counterpart of the JAX tool's
    scan inside one dispatch), so the difference cancels the replay's and
    the fence's fixed cost and leaves device time; the chain makes each
    call wait for the one before.

    ``make_input(i)`` returns fresh values for round ``i``, copied into
    the graphs' static input before the round.  ``kernel`` is the wrapper
    ``step`` calls once: its count must move by n while the n-long chain
    is captured, and ``LAUNCHES`` gains what it counted and what the
    replays launched."""
    counts = None if kernel is None else LAUNCHES[kernel.__name__]
    warm = make_input(repeats)
    if warm.device.type == "cpu":
        def run(n, x):
            _fence(_chain(step, x, n))

        run(n_lo, warm)
        run(n_hi, warm)
    else:
        # warm up on a side stream (the kernel library's load, cuBLAS's
        # handles and workspaces), as capture requires
        side = torch.cuda.Stream(warm.device)
        side.wait_stream(torch.cuda.current_stream(warm.device))
        before = kernel.launches if kernel is not None else 0
        with torch.cuda.stream(side):
            _fence(step(warm))
        torch.cuda.current_stream(warm.device).wait_stream(side)
        static = warm.clone()
        graphs = {}
        for n in (n_lo, n_hi):
            graph = torch.cuda.CUDAGraph()
            captured = kernel.launches if kernel is not None else 0
            # thread_local: a CUDA call of another thread of the process
            # (an idle server's) does not void the capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = _chain(step, static, n)
            if kernel is not None:
                captured = kernel.launches - captured
                if captured != n:
                    raise RuntimeError(
                        "a graph of {} calls captured {} launches of "
                        "{}".format(n, captured, kernel.__name__))
            graphs[n] = (graph, out, captured)
        if counts is not None:
            counts["counted"] += kernel.launches - before

        def run(n, x):
            graph, out, captured = graphs[n]
            graph.replay()
            _fence(out)
            if counts is not None:
                counts["replayed"] += captured

        run(n_lo, warm)
        run(n_hi, warm)

    best = None
    try:
        for r in range(repeats):
            x = make_input(r)
            if x.device.type != "cpu":
                # the fresh values land before the clock starts
                static.copy_(x)
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            run(n_lo, x)
            t_lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(n_hi, x)
            t_hi = time.perf_counter() - t0
            per = (t_hi - t_lo) / (n_hi - n_lo)
            if per > 0 and (best is None or per < best):
                best = per
    finally:
        if warm.device.type != "cpu":
            del graphs, static
            torch.cuda.empty_cache()
    return best if best is not None else float("nan")


def _normal(seed, shape, device):
    """bf16 standard normals from ``RandomState(seed)`` (the JAX tool's
    draw), on ``device``."""
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).to(device)


def _error_line(op, size_key, size, impl, attempt, error):
    print(json.dumps({"op": op, size_key: size, "impl": impl,
                      "attempt": attempt, "error": str(error)[:200]}),
          file=sys.stderr, flush=True)


def _arm(op, size_key, size, impl, fn, attempts=3):
    """``fn()`` with up to ``attempts`` tries; its seconds, or None after
    printing each failure's error line."""
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — report the arm's failure
            _error_line(op, size_key, size, impl, attempt, e)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return None


def flash_flops(T, heads, d):
    """The FLOPs of one causal flash call: QK^T and PV over T * T / 2
    score entries a head."""
    return 4 * T * T // 2 * heads * d


def decode_bytes(S, length_frac, kv_heads, d):
    """(live, padded) bf16 bytes of K and V one decode call needs: the
    valid prefix (the kernel never reads past a row's length) and the
    whole padded cache (what the dense arm streams)."""
    return (2 * int(S * length_frac) * kv_heads * d * 2,
            2 * S * kv_heads * d * 2)


def bench_flash(T, heads, d, scan_lens, spec, device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(T % 9973)
    k = torch.from_numpy(rng.standard_normal(
        (1, T, heads, d)).astype(np.float32)).to(torch.bfloat16).to(dev)
    v = torch.from_numpy(rng.standard_normal(
        (1, T, heads, d)).astype(np.float32)).to(torch.bfloat16).to(dev)
    # chain on q: out has q's shape; k/v stay fixed
    flops = flash_flops(T, heads, d)

    def dense_step(q):
        return _dense_attn(q, k, v)

    def flash_step(q):
        return flash_attention(q, k, v, causal=True, block_q=256,
                               block_k=256)

    def make_q(i):
        return _normal(T * 131 + i, (1, T, heads, d), dev)

    results = {}
    with torch.inference_mode():
        for name, fn, kernel in (("torch_dense", dense_step, None),
                                 ("cuda_flash", flash_step,
                                  flash_attention)):
            dt = _arm("flash_attention", "T", T, name,
                      lambda: _time_scanned(fn, make_q, scan_lens[0],
                                            scan_lens[1], kernel=kernel))
            if dt is None:
                continue
            results[name] = dt
            mfu = perf.mfu(flops, dt, spec) if spec else None
            print(json.dumps({
                "op": "flash_attention", "T": T, "heads": heads, "d": d,
                "impl": name, "ms": round(dt * 1e3, 3),
                "mfu": round(mfu, 4) if mfu is not None else None,
            }), flush=True)
    if len(results) == 2:
        print(json.dumps({
            "op": "flash_attention", "T": T,
            "kernel_speedup": round(results["torch_dense"] /
                                    results["cuda_flash"], 3),
        }), flush=True)
    return results


def bench_decode(S, length_frac, heads, kv_heads, d, scan_lens, spec,
                 device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(S % 9973)
    kc = torch.from_numpy(rng.standard_normal(
        (1, S, kv_heads, d)).astype(np.float32)).to(torch.bfloat16).to(dev)
    vc = torch.from_numpy(rng.standard_normal(
        (1, S, kv_heads, d)).astype(np.float32)).to(torch.bfloat16).to(dev)
    valid = int(S * length_frac)
    length = torch.tensor([valid], dtype=torch.int32, device=dev)
    live_bytes, padded_bytes = decode_bytes(S, length_frac, kv_heads, d)

    def dense_step(q):
        return _dense_decode(q, kc, vc, length)

    def kernel_step(q):
        return decode_attention(q, kc, vc, length, block_k=256)

    def make_q(i):
        return _normal(S * 137 + i, (1, heads, d), dev)

    results = {}
    with torch.inference_mode():
        for name, fn, nbytes, kernel in (
                ("torch_dense", dense_step, padded_bytes, None),
                ("cuda_decode", kernel_step, live_bytes,
                 decode_attention)):
            dt = _arm("decode_attention", "S", S, name,
                      lambda: _time_scanned(fn, make_q, scan_lens[0],
                                            scan_lens[1], kernel=kernel))
            if dt is None:
                continue
            results[name] = dt
            mbu = perf.mbu(nbytes, dt, spec) if spec else None
            print(json.dumps({
                "op": "decode_attention", "S": S, "valid": valid,
                "impl": name, "us": round(dt * 1e6, 1),
                "mbu": round(mbu, 4) if mbu is not None else None,
            }), flush=True)
    if len(results) == 2:
        print(json.dumps({
            "op": "decode_attention", "S": S,
            "kernel_speedup": round(results["torch_dense"] /
                                    results["cuda_decode"], 3),
        }), flush=True)
    return results


# the llama3-class head geometry the sweep runs at
HEADS, KV_HEADS, HEAD_DIM = 16, 8, 128
# chain lengths sized so the long chain holds >= ~0.5 s of device work
FLASH_LENS = {2048: (64, 1024), 8192: (8, 128), 32768: (1, 8)}
QUICK_FLASH_LENS = {2048: (64, 512)}
DECODE_CASES = ((2048, 0.25), (8192, 0.25), (8192, 1.0), (32768, 0.25),
                (32768, 1.0))
QUICK_DECODE_CASES = ((2048, 0.5),)
DECODE_LENS = (512, 8192)
QUICK_DECODE_LENS = (512, 4096)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' (a CPU run times the "
                         "kernels' plain versions)")
    return ap


def main(argv=None):
    """Run the sweep; returns the exit code (0: every arm that failed
    printed its error line, as the JAX tool's do)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec = perf.chip_spec(dev)
    for counts in LAUNCHES.values():
        counts.update(counted=0, replayed=0)
    flash_lens = QUICK_FLASH_LENS if args.quick else FLASH_LENS
    for T, lens in flash_lens.items():
        bench_flash(T, HEADS, HEAD_DIM, lens, spec, device=dev)
    decode_cases = QUICK_DECODE_CASES if args.quick else DECODE_CASES
    decode_lens = QUICK_DECODE_LENS if args.quick else DECODE_LENS
    for S, frac in decode_cases:
        bench_decode(S, frac, HEADS, KV_HEADS, HEAD_DIM, decode_lens, spec,
                     device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
