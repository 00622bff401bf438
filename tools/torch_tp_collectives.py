"""What one tensor-parallel collective costs when several processes share
one CUDA card over gloo (the port's tp=4 setup on a host with one card).

    python tools/torch_tp_collectives.py [--worlds 1,2,4] [--iters 100]

For each world size, that many processes (the ``spawn`` context, a
``file://`` store under the repo's ``build/``) join one gloo group and each
times, as the mean of ``--iters`` calls after a barrier: a host all-reduce
and all-gather of 8 KB (one decode row of Llama-3-8B in bf16), the
reduce-scatter form of the port's float sum over NCCL (an all_to_all of
the 8 KB, then an all-gather of one rank's block), a tiny
kernel and a device synchronize, the port's staged all-reduce of 8 KB
(device to host, gloo, host to device; pageable and pinned), and the
staged all-reduce of 4 MB (one 512-token prefill row block).  Prints one
JSON line per world size with the card's name and power limit and every
rank's milliseconds.  Imports no JAX and nothing of the repo; needs a
card.
"""

import argparse
import datetime
import json
import os
import subprocess
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")


def _worker(rank, world, store, iters, out):
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    x = torch.randn(4096, device="cuda").to(torch.bfloat16)
    host = torch.randn(4096).to(torch.bfloat16)
    pinned = torch.empty(4096, dtype=torch.bfloat16, pin_memory=True)
    big = torch.randn(512 * 4096, device="cuda").to(torch.bfloat16)
    parts = [torch.empty_like(host) for _ in range(world)]
    received = torch.empty_like(host)
    block = host[:4096 // world]
    blocks = [torch.empty_like(block) for _ in range(world)]
    ms = {}

    def timed(name, fn, n=iters):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / n * 1e3

    def staged():
        buf = x.cpu()
        dist.all_reduce(buf)
        x.copy_(buf)

    def staged_pinned():
        pinned.copy_(x, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        dist.all_reduce(pinned)
        x.copy_(pinned, non_blocking=True)

    def staged_4m():
        buf = big.cpu()
        dist.all_reduce(buf)
        big.copy_(buf)

    timed("host_all_reduce_8k", lambda: dist.all_reduce(host))
    timed("host_all_gather_8k", lambda: dist.all_gather(parts, host))
    timed("host_all_to_all_then_all_gather_8k",
          lambda: (dist.all_to_all_single(received, host),
                   dist.all_gather(blocks, block)))
    timed("kernel_and_synchronize",
          lambda: (x.mul_(1.0), torch.cuda.synchronize()))
    timed("staged_all_reduce_8k", staged)
    timed("staged_pinned_all_reduce_8k", staged_pinned)
    timed("staged_all_reduce_4m", staged_4m, n=max(1, iters // 5))
    out.put((rank, ms))
    dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worlds", default="1,2,4")
    parser.add_argument("--iters", type=int, default=100)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    # the card's name and power limit, beside every number
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(BUILD, exist_ok=True)
    ctx = mp.get_context("spawn")
    for world in (int(w) for w in args.worlds.split(",")):
        store = os.path.join(BUILD, "tp_collectives-{}-{}".format(
            os.getpid(), world))
        if os.path.exists(store):
            os.remove(store)
        out = ctx.Queue()
        procs = [ctx.Process(target=_worker,
                             args=(r, world, store, args.iters, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        ranks = sorted(out.get(timeout=600) for _ in procs)
        for p in procs:
            p.join(60)
        print(json.dumps({"world": world, "card": card,
                          "ms_by_rank": [m for _, m in ranks]}), flush=True)


if __name__ == "__main__":
    main()
