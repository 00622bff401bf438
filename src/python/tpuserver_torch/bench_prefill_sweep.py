"""End-to-end llama prefill/decode sweep of the port on the card.

    PYTHONPATH=src/python python -m tpuserver_torch.bench_prefill_sweep \\
        [--config llama3_8b] [--t 2048] [--max-seq 3072] [--rounds 4] \\
        [--prefill-only | --decode-only] [--device cpu]

The port's counterpart of the JAX package's prefill sweep, the tuning
companion to ``bench_full``'s config-5 rows.  It sweeps the arms that
decide the serving defaults:

- prefill: dense attention against the flash kernel at four
  (block_q, block_k) tiles, plus an attention-IDENTITY arm (the model's
  flash call patched to return q) that splits prefill time into
  "matmul+elementwise" and "attention".  The tiles only gate which
  lengths take the flash path (``llama._flash_blocks``); the CUDA kernel
  picks its own, so at a length every tile divides the four flash arms
  run the same kernel and their spread is the sweep's own noise;
- decode: dense attention against ``auto`` (the decode kernel whenever
  ``max_seq`` tiles by 256 or 128) at two contexts and two chunk sizes,
  bf16 against int8 weights (``llama.quantize_params``, whose few-row
  products run the W8A16 kernel).

Every timed arm chains its calls with DISTINCT inputs (each prefill's
first token is the previous logits' argmax, taken on the device; each
decode chunk consumes the last one's logits) and stops the clock on ONE
host fetch of result values.  Prints one JSON line per arm with the JAX
tool's keys; an arm that raises prints an error line and the sweep goes
on.  ``STATS`` holds the last run's kernel launches by arm.

Everything runs on the card unless ``--device cpu``; without a card and
without it the run raises.  ``main(argv, params=)`` takes the caller's
weights (their dtype and depth are the run's; their vocabulary must be
``--config``'s).
"""

import argparse
import dataclasses
import json
import sys
import time
import zlib

import numpy as np
import torch

from tpuserver_torch import resolve_device
from tpuserver_torch.models import llama
from tpuserver_torch.ops import flash, perf, quant

#: the last run's kernel launches: ``{"prefill": {arm: {...}}, "decode":
#: {"<weights>/<impl>/<chunk>/<ctx>": {...}}}``, each count beside the
#: prefills or decode chunks the arm ran
STATS = {}


def _launches():
    return {"flash_attention": flash.flash_attention.launches,
            "decode_attention": flash.decode_attention.launches,
            "int8_matmul": quant.int8_matmul.launches}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items()}


def _fence(x):
    """Wait for ``x`` by fetching two of its values to the host."""
    x.reshape(-1)[:2].cpu()


def _prompt(seed, vocab, n, device):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (1, n)).astype(np.int64)).to(device)


def time_prefill(cfg, params, T, max_seq, rounds, seed0, device=None):
    """Mean seconds per prefill: ``rounds`` chained prefills with
    distinct prompts (each prompt's first token depends on the previous
    logits) + one value fence."""
    dev = resolve_device(device)
    cache = llama.init_kv_cache(cfg, 1, max_seq, dev)
    prompts = [_prompt(seed0 + i, cfg.vocab, T, dev)
               for i in range(rounds + 1)]
    with torch.inference_mode():
        lg, cache = llama.prefill(params, cache, prompts[-1], cfg)  # warm
        _fence(lg)
        # warm the chaining ops outside the window too
        warm = prompts[-1].clone()
        warm[0, 0] = torch.argmax(lg[0]) % cfg.vocab
        lg, cache = llama.prefill(params, cache, warm, cfg)
        _fence(lg)
        t0 = time.perf_counter()
        for toks in prompts[:rounds]:
            chained = toks.clone()
            chained[0, 0] = torch.argmax(lg[0]) % cfg.vocab
            lg, cache = llama.prefill(params, cache, chained, cfg)
        _fence(lg)
        return (time.perf_counter() - t0) / rounds


def time_decode(cfg, params, ctx, chunk, max_seq, rounds, seed0,
                device=None):
    """tokens/sec: prefill to ``ctx``, then chain ``rounds`` decode
    chunks + one fence.  Returns (tokens/sec, the middle context)."""
    dev = resolve_device(device)
    cache = llama.init_kv_cache(cfg, 1, max_seq, dev)
    prompt = _prompt(seed0, cfg.vocab, ctx, dev)
    with torch.inference_mode():
        logits, cache = llama.prefill(params, cache, prompt, cfg)
        toks, _, logits, cache = llama.decode_chunk(
            params, cache, logits, ctx, cfg, chunk)
        _fence(toks)  # first use + settle
        pos = ctx + chunk
        n = min(rounds, (max_seq - pos) // chunk)
        if n < 1:
            raise ValueError("no room to decode past ctx")
        t0 = time.perf_counter()
        for _ in range(n):
            toks, _, logits, cache = llama.decode_chunk(
                params, cache, logits, pos, cfg, chunk)
            pos += chunk
        _fence(toks)
        dt = time.perf_counter() - t0
    return n * chunk / dt, ctx + chunk * (n // 2)


def _identity_attention(q, k, v, **kwargs):
    return q


#: (arm, config overrides, the flash call's stand-in or None)
PREFILL_ARMS = (
    ("dense", dict(attn_impl="dense"), None),
    ("flash_128x128", dict(attn_impl="kernel", flash_block_q=128,
                           flash_block_k=128), None),
    ("flash_256x256", dict(attn_impl="kernel", flash_block_q=256,
                           flash_block_k=256), None),
    ("flash_512x512", dict(attn_impl="kernel", flash_block_q=512,
                           flash_block_k=512), None),
    ("flash_256x512", dict(attn_impl="kernel", flash_block_q=256,
                           flash_block_k=512), None),
    # the decomposition arm: attention replaced by the identity, which
    # leaves the matmul+elementwise cost
    ("attention_identity", dict(attn_impl="kernel", flash_block_q=128,
                                flash_block_k=128), _identity_attention),
)
DECODE_IMPLS = ("dense", "auto")
DECODE_CHUNKS = (32, 64)
DECODE_CTXS = (512, 2048)


def prefill_arm(base, params, arm, T, max_seq, rounds, seed0, device=None):
    """Seconds per prefill of one entry of ``PREFILL_ARMS``: the model's
    flash call (``llama.flash_attention``, bound when the model module
    was imported) is replaced by the arm's stand-in for the run and put
    back after it, whatever happens."""
    name, overrides, patch = arm
    cfg = dataclasses.replace(base, **overrides)
    real_flash = llama.flash_attention
    if patch is not None:
        llama.flash_attention = patch
    try:
        return time_prefill(cfg, params, T, max_seq, rounds, seed0,
                            device=device)
    finally:
        llama.flash_attention = real_flash


def decode_seed(weights, impl, chunk, ctx):
    """A prompt seed for one decode arm, the same in every process."""
    return zlib.crc32("{}/{}/{}/{}".format(
        weights, impl, chunk, ctx).encode()) % 100000


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="llama3_8b",
                    choices=sorted(llama.PRESETS))
    ap.add_argument("--t", type=int, default=2048)
    ap.add_argument("--max-seq", type=int, default=3072)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--prefill-only", action="store_true")
    ap.add_argument("--decode-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    return ap


def _config(name, params):
    """The preset ``name``, at the dtype and depth of ``params`` when
    given (bf16 and the preset's depth when drawn), checked against their
    vocabulary."""
    cfg = llama.PRESETS[name]()
    if params is None:
        return cfg
    embed = params["embed"]
    rows = (embed["q"] if quant.is_quantized(embed) else embed).shape[0]
    if rows != cfg.vocab:
        raise ValueError(
            "params ({} embedding rows) do not match --config {} (vocab "
            "{})".format(rows, name, cfg.vocab))
    return dataclasses.replace(cfg, dtype=params["norm"].dtype,
                               n_layers=len(params["layers"]))


def main(argv=None, params=None):
    """Run the sweep; returns 0 (a failed arm prints its error line, as
    the JAX tool's do).  ``params``: the weights, else drawn from seed 0
    on the device."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    base = _config(args.config, params)
    spec = perf.chip_spec(dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = llama.init_params(base, gen, dev)
    pf = perf.prefill_flops(base, args.t)
    STATS.clear()
    STATS.update(prefill={}, decode={})

    if not args.decode_only:
        for i, arm in enumerate(PREFILL_ARMS):
            name = arm[0]
            before = _launches()
            try:
                dt = prefill_arm(base, params, arm, args.t, args.max_seq,
                                 args.rounds, seed0=1000 * (i + 1),
                                 device=dev)
            except Exception as e:  # noqa: BLE001 — report arm failures
                print(json.dumps({
                    "phase": "prefill", "arm": name,
                    "error": str(e)[:200]}), flush=True)
                continue
            finally:
                STATS["prefill"][name] = dict(_delta(before),
                                              prefills=args.rounds + 2)
            mfu = perf.mfu(pf, dt, spec) if spec else None
            print(json.dumps({
                "phase": "prefill", "config": args.config, "T": args.t,
                "arm": name, "ms": round(dt * 1e3, 2),
                "mfu": round(mfu, 4) if mfu is not None else None,
            }), flush=True)

    if not args.prefill_only:
        with torch.inference_mode():
            qparams = llama.quantize_params(params)
        for wname, wparams, wbytes in (
                ("bf16", params, 2), ("int8", qparams, 1)):
            for impl in DECODE_IMPLS:
                for chunk in DECODE_CHUNKS:
                    for ctx in DECODE_CTXS:
                        cfg = dataclasses.replace(base, decode_impl=impl)
                        key = "{}/{}/{}/{}".format(wname, impl, chunk, ctx)
                        before = _launches()
                        try:
                            rate, ctx_mid = time_decode(
                                cfg, wparams, ctx, chunk, args.max_seq,
                                2 * args.rounds,
                                seed0=decode_seed(wname, impl, chunk, ctx),
                                device=dev)
                        except Exception as e:  # noqa: BLE001
                            print(json.dumps({
                                "phase": "decode", "arm": impl,
                                "weights": wname, "chunk": chunk,
                                "ctx": ctx, "error": str(e)[:200],
                            }), flush=True)
                            continue
                        finally:
                            STATS["decode"][key] = _delta(before)
                        bpt = perf.decode_bytes_per_token(
                            base, ctx_mid, weight_bytes_per_param=wbytes)
                        mbu = (perf.mbu(bpt * rate, 1.0, spec)
                               if spec else None)
                        print(json.dumps({
                            "phase": "decode", "config": args.config,
                            "weights": wname, "impl": impl,
                            "chunk": chunk, "ctx": ctx_mid,
                            "tokens_per_sec": round(rate, 1),
                            "mbu": round(mbu, 4) if mbu else None,
                        }), flush=True)
        del qparams
    return 0


if __name__ == "__main__":
    sys.exit(main())
