// One fused CRBE time step with the uniform operator and Chebyshev
// iterations, one block per output tile; the caller loops over steps.
//
// Replaces airpollution_tpu/ops/pallas_hbm.py::_step_kernel, which streams
// row stripes of the state through VMEM with a double-buffered DMA and a
// halo of roundup8(k + 2 (+1 CN)) rows. The TPU tiles rows only, because its
// DMA wants full 128-lane rows; here each block owns a 2-D tile and takes the
// halo in both directions (every matvec reaches +-1 row and +-1 column), and
// no rounding of the halo is needed. The step itself is tile_step
// (tile_step.cuh).
//
// What bounds it: device memory sees one read of u (and u_prev) per window
// and one write per tile, about 2 x 3 x n^2 x sizeof(T) per carried state
// and step; the arithmetic, k + 1 stencil applications over the shrinking
// window, runs from shared memory and is the larger cost at k = 8. The
// design keeps every intermediate of the step in shared memory, so the
// device-memory traffic does not grow with k.
//
// `halt` points at the solve's divergence flag on the device: once a guard
// chunk has tripped it (>= 0), later launches return at once, so a diverged
// run stops computing without a host read per chunk.

#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace crbe {

template <int NT, typename T>
__global__ void __launch_bounds__(NT)
    uniform_step_kernel(Geometry g, const T* scal, const T* u_in,
                        const T* up_in, T* u_out, T* up_out, const int* halt) {
  if (halt != nullptr && *halt >= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s[kMaxScal];
  T* smem = reinterpret_cast<T*>(smem_raw);
  load_scalars(scal, s, g.n_iters);
  StepIO<T> io;
  io.u_in = u_in;
  io.up_in = up_in;
  io.u_out = u_out;
  io.up_out = up_out;
  tile_step<NT>(g, s, io, blockIdx.x, smem);
}

template <int NT, typename T>
int launch_step_nt(const T* scal, const T* u_in, const T* up_in, T* u_out,
                   T* up_out, const int* halt, Geometry g, void* stream) {
  const size_t smem = smem_bytes(g.tile, g.halo, sizeof(T));
  // The attribute is per kernel; raise it only when a launch needs more.
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        uniform_step_kernel<NT, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  uniform_step_kernel<NT, T><<<g.tiles_per_row * g.tiles_per_row, NT, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      g, scal, u_in, up_in, u_out, up_out, halt);
  return cudaGetLastError();
}

template <typename T>
int launch_step(const T* scal, const T* u_in, const T* up_in, T* u_out,
                T* up_out, const int* halt, int n, int tile, int halo,
                int n_iters, int use_ka, int threads, void* stream) {
  if (n_iters < 1 || n_iters > kMaxIters) return cudaErrorInvalidValue;
  Geometry g;
  g.n = n;
  g.tile = tile;
  g.halo = halo;
  g.tiles_per_row = (n + tile - 1) / tile;
  g.n_iters = n_iters;
  g.use_ka = use_ka;
  if (threads == 256) {
    return launch_step_nt<256>(scal, u_in, up_in, u_out, up_out, halt, g,
                               stream);
  }
  if (threads == 512) {
    return launch_step_nt<512>(scal, u_in, up_in, u_out, up_out, halt, g,
                               stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace crbe

extern "C" {

int crbe_uniform_step_f32(const float* scal, const float* u_in,
                          const float* up_in, float* u_out, float* up_out,
                          const int* halt, int n, int tile, int halo,
                          int n_iters, int use_ka, int threads,
                          void* stream) {
  return crbe::launch_step<float>(scal, u_in, up_in, u_out, up_out, halt, n,
                                  tile, halo, n_iters, use_ka, threads,
                                  stream);
}

int crbe_uniform_step_f64(const double* scal, const double* u_in,
                          const double* up_in, double* u_out, double* up_out,
                          const int* halt, int n, int tile, int halo,
                          int n_iters, int use_ka, int threads,
                          void* stream) {
  return crbe::launch_step<double>(scal, u_in, up_in, u_out, up_out, halt, n,
                                   tile, halo, n_iters, use_ka, threads,
                                   stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
