"""Times the PyTorch port's attention kernels of several source trees on
one card, with the method of ``chip_smoke.py`` (CUDA events around each
launch, L2 flushed by a 64 MB read before it, the card held while the
host enqueues), so that two commits compare within one run:

    git archive <parent> src/python/tpuserver_torch | tar -x -C parent/
    python3 tools/torch_kernel_ab.py parent . . parent

Each argument is the root of a tree holding ``src/python/tpuserver_torch``;
each runs in its own process (the trees share module names) and builds
its kernels into its own ``build/``.  One JSON line per run: decode
attention at lengths 576 and 4096 and causal flash attention at T 512
and 2048, Llama-3-8B shapes, bf16, the W8A16 product
(``ops/quant.py::int8_matmul``, where the tree has it) at Llama-3-8B's five
weight shapes and 1, 8 and 40 rows beside the bf16 ``torch.matmul`` of the
same weights, with one decode step's sums (32 layers x 7 products and the
lm_head), and the method's floor (one elementwise kernel on one element),
in ms.  Needs a CUDA card.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def time_tree(root):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src", "python"))
    import torch

    from tpuserver_torch.ops import _build
    from tpuserver_torch.ops import flash as fl

    # after the tree's own modules: chip_smoke puts this repo's
    # src/python first on the path when it is imported
    sys.path.insert(1, REPO)
    from chip_smoke import _time_ms

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: needs a CUDA card")
    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    h, hkv, d, s = 32, 8, 128, 4096
    row = {"root": root, "source": str(fl.__file__)}
    q = torch.randn(1, h, d, device=dev, generator=gen).to(torch.bfloat16)
    kc = torch.randn(1, s, hkv, d, device=dev, generator=gen).to(
        torch.bfloat16)
    vc = torch.randn(1, s, hkv, d, device=dev, generator=gen).to(
        torch.bfloat16)
    for n in (576, 4096):
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        row["decode_{}_ms".format(n)] = _time_ms(
            torch, lambda: fl.decode_attention(q, kc, vc, lens), 200, flush)
    for t in (512, 2048):
        qq, kk, vv = (torch.randn(1, t, hh, d, device=dev, generator=gen).to(
            torch.bfloat16) for hh in (h, hkv, hkv))
        row["flash_{}_ms".format(t)] = _time_ms(
            torch, lambda: fl.flash_attention(qq, kk, vv, causal=True), 50,
            flush)
    try:
        from tpuserver_torch.ops import quant
    except ImportError:
        quant = None
    if quant is not None:
        row.update(_int8_times(torch, quant, dev, gen, flush, _time_ms))
    # the method's floor: one elementwise kernel on one element
    one = torch.zeros(1, device=dev)
    row["event_floor_ms"] = _time_ms(torch, lambda: one.add_(1), 200, flush)
    print(json.dumps(row), flush=True)


# Llama-3-8B's weight-only products, (K, N): how often one decode step
# runs each (32 layers: wq and wo, wk and wv, w_gate and w_up, w_down; the
# lm_head once)
INT8_STEP_USES = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64,
                  (14336, 4096): 32, (4096, 128256): 1}


def _int8_times(torch, quant, dev, gen, flush, time_ms):
    out = {}
    step = {}
    for (k, n), uses in INT8_STEP_USES.items():
        w = (torch.randn(k, n, device=dev, generator=gen) / k ** 0.5).to(
            torch.bfloat16)
        qw = quant.quantize_int8(w)
        x = torch.randn(40, k, device=dev, generator=gen).to(torch.bfloat16)
        for m in (1, 8, 40):
            xm = x[:m]
            ms = time_ms(torch, lambda: quant.int8_matmul(xm, qw["q"],
                                                          qw["s"]), 50, flush)
            bf = time_ms(torch, lambda: xm @ w, 50, flush)
            out["int8_{}x{}_m{}_ms".format(k, n, m)] = ms
            out["bf16_{}x{}_m{}_ms".format(k, n, m)] = bf
            s = step.setdefault(m, [0.0, 0.0])
            s[0] += uses * ms
            s[1] += uses * bf
        del w, qw, x
    for m, (ms, bf) in step.items():
        out["int8_step_m{}_ms".format(m)] = ms
        out["bf16_step_m{}_ms".format(m)] = bf
    return out


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(argv[1])
        return 0
    if not argv:
        sys.exit(__doc__)
    rc = 0
    for root in argv:
        run = subprocess.run([sys.executable, __file__, "--one", root],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, timeout=600)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stdout.write("{} failed:\n{}\n".format(root, run.stderr[-3000:]))
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
