"""Times the PyTorch port's attention kernels of several source trees on
one card at the shapes of ``chip_smoke.py``'s phase 20 (a) (every route
beyond the bf16 presets' shapes: ``KD_FLASH_CASES``, ``KD_DECODE_CASES``)
and at the Llama-3-8B tensor-core shapes phase 3 times (flash at T 512
and 2048, flash at Llama-3.2-1B's head dim, decode at 576 and 4096 keys
and the batched step), so that two commits compare within one run:

    git archive <parent> | tar -x -C parent/
    python3 tools/torch_attention_domain_ab.py parent . . parent

Each argument is the root of a checkout; each runs in its own process
with that checkout's ``chip_smoke.py`` and kernels (built into its own
``build/``), by chip_smoke's method (CUDA events around each launch, L2
flushed by a 64 MB read before it).  One line per run, ``KDTIME`` and a
JSON object: the launches by route and, by case, [kernel ms, library ms
(masked SDPA; live SDPA for decode), row-relative error against the plain
version].  Needs a CUDA card.
"""

import json
import os
import subprocess
import sys


def time_tree(root):
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src", "python")]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs

    cs.phase_device(torch)
    cs.phase_build()
    from tpuserver_torch.ops import flash as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for case in cs.KD_FLASH_CASES:
        r = cs._kd_flash_case(torch, F, fl, dev, gen, case, flush)
        out["flash_" + case[0]] = (r["ms"], r["library_ms"], r["row_rel_err"])
    for case in cs.KD_DECODE_CASES:
        r = cs._kd_decode_case(torch, F, fl, dev, gen, case, flush)
        out["decode_" + case[0]] = (r["ms"], r["library_live_ms"],
                                    r["row_rel_err"])
    bf16 = torch.bfloat16
    for name, args in (("tc_flash_512", (1, 512, 32, 8, 128, True)),
                       ("tc_flash_2048", (1, 2048, 32, 8, 128, True)),
                       ("tc_flash_1b_256", (2, 256, 16, 8, 64, True))):
        r = cs._flash_case(torch, F, fl, dev, gen, *args, bf16, True, flush)
        out[name] = (r["ms"], r["library_ms"], r["row_rel_err"])
    for name, lengths in (("tc_decode_576", (576,)),
                          ("tc_decode_4096", (4096,)),
                          ("tc_decode_b8", cs.BATCHED_LENGTHS)):
        r = cs._decode_case(torch, F, fl, dev, gen, lengths, 4096, 32, 8,
                            128, bf16, True, flush)
        out[name] = (r["ms"], r["library_live_ms"], r["row_rel_err"])
    print("KDTIME", json.dumps({"tree": root, "routes": {
        "flash": dict(fl.flash_attention.route_launches),
        "decode": dict(fl.decode_attention.route_launches)}, "ms": out}),
        flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--tree":
        time_tree(argv[1])
        return 0
    rc = 0
    for root in argv:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                               "--tree", root])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
