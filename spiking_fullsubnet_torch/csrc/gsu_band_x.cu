// The host side of the peer route's band exchange: each rank's exchange
// buffer (layout: gsu_train_mma.cuh, ops/gsu_kernels.exchange_layout), its
// CUDA IPC handle for the other ranks of the band group, a peer's buffer
// mapped into this process, and the copy of the rank's error record that
// the wrappers read without blocking (ops/gsu_kernels.BandExchange). No
// kernel: kernels D and E in band mode do the exchange itself
// (gsu_train_fwd.cu, gsu_train_bwd.cu), and parallel/mesh.band_setup sets
// the buffers up once a group.
#include <cuda_runtime.h>

extern "C" {

// A rank's buffer: `bytes` of device memory on `device`, zeroed, and its
// CUDA IPC handle (64 bytes). The calling thread's current device is left
// as it was.
int gsu_band_x_alloc(int device, long long bytes, void** ptr, void* handle) {
  int old = 0;
  cudaError_t e = cudaGetDevice(&old);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  cudaSetDevice(old);
  return (int)e;
}

// A peer's buffer mapped into this process (peer access enabled lazily).
int gsu_band_x_open(int device, const void* handle, void** ptr) {
  int old = 0;
  cudaError_t e = cudaGetDevice(&old);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
                             cudaIpcMemLazyEnablePeerAccess);
  cudaSetDevice(old);
  return (int)e;
}

// Unmaps a peer's buffer (open), or frees this rank's own (free != 0).
int gsu_band_x_release(int device, void* ptr, int free) {
  int old = 0;
  cudaError_t e = cudaGetDevice(&old);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) e = free ? cudaFree(ptr) : cudaIpcCloseMemHandle(ptr);
  cudaSetDevice(old);
  return (int)e;
}

// The error record (8 ints at `err`) copied into pinned host memory `host`
// on `stream`, after the launches before it; the host does not wait.
int gsu_band_x_post(const void* err, void* host, void* stream) {
  return (int)cudaMemcpyAsync(host, err, 8 * sizeof(int), cudaMemcpyDeviceToHost,
                              static_cast<cudaStream_t>(stream));
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
