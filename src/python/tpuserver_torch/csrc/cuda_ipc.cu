// CUDA IPC for the port's shared-memory data plane
// (tpuserver_torch/cuda_shared_memory.py).  No kernel: these calls make the
// device memory a region names, and map it in another process.  They are
// the card's counterpart of the cross-process device-buffer export that
// the TPU's public runtime lacks (tritonclient/utils/xla_shared_memory
// stages through host shared memory instead).
//
// A region is one cudaMalloc allocation, never a block of PyTorch's caching
// allocator: cudaIpcGetMemHandle names a whole allocation, and Triton's
// CUDA-shm wire format (a bare 64-byte cudaIpcMemHandle_t) has no offset.
//
// Every call returns the cudaError_t; the Python side raises on nonzero.
// Each call selects ``device`` for its own duration and restores the
// caller's device.

#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

static_assert(sizeof(cudaIpcMemHandle_t) == 64,
              "Triton's CUDA-shm handle is 64 bytes");

namespace {

// Runs fn with ``device`` current, then makes the caller's device current
// again; the first error wins.
template <typename F>
cudaError_t on_device_(int device, F fn) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaError_t r = fn();
  e = cudaSetDevice(prev);
  return r != cudaSuccess ? r : e;
}

// on_device_, and a failure is also taken off the thread's last-error
// state, where the runtime leaves it: the code goes back to the caller, and
// the next kernel launch's cudaGetLastError() check must not report it.
template <typename F>
int on_device(int device, F fn) {
  const cudaError_t e = on_device_(device, fn);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // namespace

// cudaMalloc of ``bytes`` on ``device``, zero-filled (a fresh region reads
// as zeros, as a fresh POSIX-shm region does), into *ptr.
extern "C" int tt_ipc_malloc(size_t bytes, int device, void** ptr) {
  *ptr = nullptr;
  return on_device(device, [&]() {
    cudaError_t e = cudaMalloc(ptr, bytes);
    if (e != cudaSuccess) return e;
    e = cudaMemset(*ptr, 0, bytes);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e != cudaSuccess) {
      cudaFree(*ptr);
      *ptr = nullptr;
    }
    return e;
  });
}

// cudaFree of a tt_ipc_malloc allocation, after the device's work in flight
// has completed: a copy still reading or writing the region finishes first.
extern "C" int tt_ipc_free(void* ptr, int device) {
  return on_device(device, [&]() {
    cudaError_t e = cudaDeviceSynchronize();
    return e != cudaSuccess ? e : cudaFree(ptr);
  });
}

// The allocation's cudaIpcMemHandle_t, as 64 bytes into out.
extern "C" int tt_ipc_get_handle(void* ptr, int device, unsigned char* out) {
  return on_device(device, [&]() {
    cudaIpcMemHandle_t h;
    cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
    if (e == cudaSuccess) memcpy(out, &h, sizeof(h));
    return e;
  });
}

// Maps another process's allocation from its 64-byte handle on ``device``
// into *ptr.  Fails (cudaErrorInvalidContext or similar) on a handle this
// process made: the caller keeps its own registry for that case.
extern "C" int tt_ipc_open(const unsigned char* handle, int device,
                           void** ptr) {
  *ptr = nullptr;
  return on_device(device, [&]() {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

// Unmaps a tt_ipc_open mapping; the memory stays its owner's.
extern "C" int tt_ipc_close(void* ptr, int device) {
  return on_device(device, [&]() { return cudaIpcCloseMemHandle(ptr); });
}

// The runtime's name for an error code these calls returned.
extern "C" const char* tt_ipc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
