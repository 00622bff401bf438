"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, ``build/tpuserver_torch/libkernels.so`` at the repository root,
which is loaded with ``ctypes``.  The build runs at first use and again
whenever the hash of the sources or flags changes; a failed build raises.
Nothing here runs at import time: this module imports on machines with no
``nvcc`` and no card.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "tpuserver_torch"
LIB_NAME = "libkernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds the last build in this process took (0.0 when the library
#: was already current), for reporting
last_build_seconds = 0.0

_i64 = ctypes.c_int64
_int = ctypes.c_int
_ptr = ctypes.c_void_p


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu"))


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def build():
    """Compile the kernels if the library is missing or stale; returns
    its path.  Raises RuntimeError when ``nvcc`` is absent or fails."""
    global last_build_seconds
    build_dir = Path(BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / LIB_NAME
    stamp = build_dir / "libkernels.hash"
    want = source_hash()
    with open(build_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and stamp.exists() and stamp.read_text() == want:
            last_build_seconds = 0.0
            return lib
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc not found on PATH or "
                "at /usr/local/cuda/bin/nvcc")
        t0 = time.monotonic()
        procs = []
        for src in _sources():
            obj = build_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append("== {}\n{}".format(
                src.name, out.decode(errors="replace")))
            if proc.returncode != 0:
                failed.append(src.name)
        (build_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed on {}:\n{}".format(
                ", ".join(failed), "\n".join(log)))
        tmp = build_dir / (LIB_NAME + ".tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("linking the CUDA kernels failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp, lib)
        stamp.write_text(want)
        last_build_seconds = time.monotonic() - t0
        return lib


@functools.lru_cache(maxsize=None)
def load_library():
    """The built kernel library, with every entry point's C signature
    declared (pointers and the stream as ``void*``, strides as int64)."""
    lib = ctypes.CDLL(str(build()))
    lib.tt_decode_attention.argtypes = (
        [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr] + [_int] * 6
        + [ctypes.POINTER(_i64), ctypes.c_float, _ptr])
    lib.tt_decode_attention.restype = _int
    lib.tt_flash_attention.argtypes = (
        [_int, _ptr, _ptr, _ptr, _ptr] + [_int] * 7
        + [ctypes.POINTER(_i64), ctypes.c_float, _ptr])
    lib.tt_flash_attention.restype = _int
    lib.tt_flash_tile_product.argtypes = [_ptr] * 6
    lib.tt_flash_tile_product.restype = _int
    lib.tt_int8_matmul.argtypes = ([_ptr, _i64] + [_ptr] * 5 + [_int] * 5
                                   + [_ptr])
    lib.tt_int8_matmul.restype = _int
    # CUDA IPC of the shared-memory regions (csrc/cuda_ipc.cu)
    lib.tt_ipc_malloc.argtypes = [ctypes.c_size_t, _int,
                                  ctypes.POINTER(_ptr)]
    lib.tt_ipc_free.argtypes = [_ptr, _int]
    lib.tt_ipc_get_handle.argtypes = [_ptr, _int, ctypes.c_char_p]
    lib.tt_ipc_open.argtypes = [ctypes.c_char_p, _int, ctypes.POINTER(_ptr)]
    lib.tt_ipc_close.argtypes = [_ptr, _int]
    for fn in (lib.tt_ipc_malloc, lib.tt_ipc_free, lib.tt_ipc_get_handle,
               lib.tt_ipc_open, lib.tt_ipc_close):
        fn.restype = _int
    lib.tt_ipc_error_string.argtypes = [_int]
    lib.tt_ipc_error_string.restype = ctypes.c_char_p
    return lib
