"""Where the flash kernel's time goes, phase by phase, on the card.

    python3 tools/torch_flash_clocks.py

Builds a copy of ``src/python/tpuserver_torch/csrc/flash_attention.cu``
with ``clock64()`` reads around each phase of the consumer loop (inserted
at fixed lines of the source; the tool fails if they moved) into
``build/torch_flash_clocks/``, runs causal flash attention at Llama-3-8B
shapes (bf16, T 512 and 2048) through the port's wrapper, and prints, for
the block that holds the longest query tile, each consumer warpgroup's
cycles spent waiting for Q, waiting for K/V tiles, in S = Q K^T, in the
softmax and in O += P V, summed over its key tiles.  Needs a CUDA card
and ``nvcc``.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src", "python", "tpuserver_torch", "csrc")
OUT = os.path.join(REPO, "build", "torch_flash_clocks")
PHASES = ("q_wait", "kv_wait", "qk", "softmax", "pv")

# (anchor in the kernel source, text put after it)
PROBES = (
    ('''namespace {

constexpr int kBq''', None),
    ('''  mbar_wait(qbar, 0);
''', '''  const unsigned long long c_q = clock64() - c_start;
'''),
    ('''    const int s = t % kStages;
''', '''    c0 = clock64();
'''),
    ('''    mbar_wait(&full[s], (t / kStages) & 1);
''', '''    c1 = clock64();
    clk[1] += c1 - c0;
'''),
    ('''      fence_regs<32>(sc);

''', '''      c0 = clock64();
      clk[2] += c0 - c1;
'''),
    ('''      pack_p(sc, pa);
''', '''      c1 = clock64();
      clk[3] += c1 - c0;
'''),
    ('''      fence_regs<D / 2>(o);
''', '''      clk[4] += clock64() - c1;
'''),
)

HEADER = '''__device__ unsigned long long tt_phase_clocks[2][5];
extern "C" int tt_flash_phase_clocks(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, tt_phase_clocks,
                                   sizeof(tt_phase_clocks));
}

'''
LOOP_START = '''  mbar_wait(qbar, 0);
'''
LOOP_PROLOGUE = '''  unsigned long long clk[5] = {0, 0, 0, 0, 0}, c0 = 0, c1 = 0;
  const unsigned long long c_start = clock64();
'''
EPILOGUE_ANCHOR = '''  // finish: full row sums over the quad, normalise, store
'''
EPILOGUE = '''  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      (tid & 127) == 0) {
    clk[0] = c_q;
    for (int i = 0; i < 5; ++i) tt_phase_clocks[wg][i] = clk[i];
  }
'''


def instrumented_source():
    src = open(os.path.join(SRC, "flash_attention.cu")).read()

    def insert_after(text, anchor, added, start):
        at = text.find(anchor, start)
        if at < 0:
            sys.exit("torch_flash_clocks: anchor not found in the kernel "
                     "source:\n" + anchor)
        at += len(anchor)
        return text[:at] + added + text[at:], at

    # the header goes before the anonymous namespace
    at = src.index(PROBES[0][0])
    src = src[:at] + HEADER + src[at:]
    kernel_at = src.index("flash_attention_kernel(")
    at = src.index(LOOP_START, kernel_at)
    src = src[:at] + LOOP_PROLOGUE + src[at:]
    pos = at
    for anchor, added in PROBES[1:]:
        src, pos = insert_after(src, anchor, added, pos)
    at = src.index(EPILOGUE_ANCHOR, pos)
    return src[:at] + EPILOGUE + src[at:]


def build():
    from tpuserver_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(SRC, "common.cuh"), OUT)
    cu = os.path.join(OUT, "flash_attention.cu")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    lib = os.path.join(OUT, "libflashclocks.so")
    nvcc = _build.nvcc_path()
    if nvcc is None:
        sys.exit("torch_flash_clocks: nvcc not found")
    run = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        sys.exit("torch_flash_clocks: nvcc failed:\n" + run.stdout[-4000:])
    return lib


def main():
    sys.path.insert(0, os.path.join(REPO, "src", "python"))
    import torch

    from tpuserver_torch.ops import _build
    from tpuserver_torch.ops import flash as fl

    if not torch.cuda.is_available():
        sys.exit("torch_flash_clocks: needs a CUDA card")
    lib = ctypes.CDLL(build())
    i64, cint, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.tt_flash_attention.argtypes = (
        [cint, cint, ptr, ptr, ptr, ptr] + [cint] * 7
        + [ctypes.POINTER(i64), ctypes.c_float, ptr])
    lib.tt_flash_attention.restype = cint
    lib.tt_flash_phase_clocks.argtypes = [ptr]
    lib.tt_flash_phase_clocks.restype = cint
    _build.load_library = lambda: lib  # the wrapper launches this build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for t in (512, 2048):
        q, k, v = (torch.randn(1, t, hh, 128, device=dev, generator=gen).to(
            torch.bfloat16) for hh in (32, 8, 8))
        for _ in range(3):
            fl.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * 10)()
        if lib.tt_flash_phase_clocks(host) != 0:
            sys.exit("torch_flash_clocks: reading the clocks failed")
        for wg in range(2):
            print(json.dumps({"t": t, "warpgroup": wg, "cycles": {
                name: host[wg * 5 + i] for i, name in enumerate(PHASES)}}),
                flush=True)


if __name__ == "__main__":
    main()
