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
// Source loads: the second entry point (crbe_uniform_step_load_*) adds one
// (3, n, n) plane, built by the caller in torch (ops/loads.EmissionLoads),
// to the right-hand side, as the TPU kernel adds the load it evaluates
// in-kernel; it is the kLoad = true instantiation, so the load-free step
// compiles as it did before loads existed. The load adds one read of
// 3 n^2 values per step.
//
// `halt` points at the solve's divergence flag on the device: once a guard
// chunk has tripped it (>= 0), later launches return at once, so a diverged
// run stops computing without a host read per chunk.
//
// Kernel B8 (entry points crbe_uniform_block_step_*, with and without a
// load): the same step on one row block of the canvas, the counterpart of
// the TPU kernel's sharded-block mode that
// airpollution_tpu/parallel/hbm_shard.py launches per device
// (build_hbm_halo_solver, int_start = halo and the global-row scalar row0 =
// d local - halo). It is the kBlock instantiation of tile_step (see
// tile_step.cuh): the grid covers the interior tiles of an extended block
// of rows = local + 2 halo rows, the masks use global rows, and only the
// interior is written. One launch per block and step; device memory sees
// the extended block's state (and load) once and the interior once, so the
// halo rows add 2 halo / local to the whole-canvas step's traffic.

#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace crbe {

template <int NT, typename T, bool kLoad, bool kBlock>
__global__ void __launch_bounds__(NT)
    uniform_step_kernel(Geometry g, const T* scal, const T* u_in,
                        const T* up_in, T* u_out, T* up_out, const int* halt,
                        const T* load) {
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
  io.load = load;
  tile_step<NT, T, kLoad, kBlock>(g, s, io, blockIdx.x, smem);
}

template <int NT, typename T, bool kLoad, bool kBlock>
int launch_step_nt(const T* scal, const T* u_in, const T* up_in, T* u_out,
                   T* up_out, const int* halt, const T* load, Geometry g,
                   void* stream) {
  const size_t smem = smem_bytes(g.tile, g.halo, sizeof(T));
  // The attribute is per kernel; raise it only when a launch needs more.
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        uniform_step_kernel<NT, T, kLoad, kBlock>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  uniform_step_kernel<NT, T, kLoad, kBlock>
      <<<g.tile_rows * g.tiles_per_row, NT, smem,
         static_cast<cudaStream_t>(stream)>>>(g, scal, u_in, up_in, u_out,
                                              up_out, halt, load);
  return cudaGetLastError();
}

// Checks the launch and dispatches on the block size.
template <typename T, bool kLoad, bool kBlock>
int launch_step_as(const T* scal, const T* u_in, const T* up_in, T* u_out,
                   T* up_out, const int* halt, const T* load, Geometry g,
                   int threads, void* stream) {
  if (g.n_iters < 1 || g.n_iters > kMaxIters) return cudaErrorInvalidValue;
  if (kLoad && load == nullptr) return cudaErrorInvalidValue;
  if (g.halo < g.n_iters + (g.use_ka ? 1 : 0)) return cudaErrorInvalidValue;
  if (kBlock && !block_fits(g)) return cudaErrorInvalidValue;
  if (threads == 512) {
    return launch_step_nt<512, T, kLoad, kBlock>(scal, u_in, up_in, u_out,
                                                 up_out, halt, load, g,
                                                 stream);
  }
  if constexpr (!kBlock) {
    if (threads == 256) {
      return launch_step_nt<256, T, kLoad, false>(scal, u_in, up_in, u_out,
                                                  up_out, halt, load, g,
                                                  stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool kLoad>
int launch_step(const T* scal, const T* u_in, const T* up_in, T* u_out,
                T* up_out, const int* halt, const T* load, int n, int tile,
                int halo, int n_iters, int use_ka, int threads,
                void* stream) {
  return launch_step_as<T, kLoad, false>(
      scal, u_in, up_in, u_out, up_out, halt, load,
      step_geometry(n, tile, halo, n_iters, use_ka), threads, stream);
}

template <typename T, bool kLoad>
int launch_block_step(const T* scal, const T* u_in, const T* up_in, T* u_out,
                      T* up_out, const int* halt, const T* load, int n,
                      int rows, int row0, int int_lo, int int_hi, int tile,
                      int halo, int n_iters, int use_ka, void* stream) {
  return launch_step_as<T, kLoad, true>(
      scal, u_in, up_in, u_out, up_out, halt, load,
      block_geometry(n, rows, row0, int_lo, int_hi, tile, halo, n_iters,
                     use_ka),
      kBlockThreads, stream);
}

}  // namespace crbe

extern "C" {

int crbe_uniform_step_f32(const float* scal, const float* u_in,
                          const float* up_in, float* u_out, float* up_out,
                          const int* halt, int n, int tile, int halo,
                          int n_iters, int use_ka, int threads,
                          void* stream) {
  return crbe::launch_step<float, false>(scal, u_in, up_in, u_out, up_out,
                                         halt, nullptr, n, tile, halo,
                                         n_iters, use_ka, threads, stream);
}

int crbe_uniform_step_f64(const double* scal, const double* u_in,
                          const double* up_in, double* u_out, double* up_out,
                          const int* halt, int n, int tile, int halo,
                          int n_iters, int use_ka, int threads,
                          void* stream) {
  return crbe::launch_step<double, false>(scal, u_in, up_in, u_out, up_out,
                                          halt, nullptr, n, tile, halo,
                                          n_iters, use_ka, threads, stream);
}

int crbe_uniform_step_load_f32(const float* scal, const float* u_in,
                               const float* up_in, float* u_out,
                               float* up_out, const int* halt,
                               const float* load, int n, int tile, int halo,
                               int n_iters, int use_ka, int threads,
                               void* stream) {
  return crbe::launch_step<float, true>(scal, u_in, up_in, u_out, up_out,
                                        halt, load, n, tile, halo, n_iters,
                                        use_ka, threads, stream);
}

int crbe_uniform_step_load_f64(const double* scal, const double* u_in,
                               const double* up_in, double* u_out,
                               double* up_out, const int* halt,
                               const double* load, int n, int tile, int halo,
                               int n_iters, int use_ka, int threads,
                               void* stream) {
  return crbe::launch_step<double, true>(scal, u_in, up_in, u_out, up_out,
                                         halt, load, n, tile, halo, n_iters,
                                         use_ka, threads, stream);
}

// Kernel B8: u_in, up_in, u_out, up_out and load are (3, rows, n) blocks.
int crbe_uniform_block_step_f32(const float* scal, const float* u_in,
                                const float* up_in, float* u_out,
                                float* up_out, const int* halt, int n,
                                int rows, int row0, int int_lo, int int_hi,
                                int tile, int halo, int n_iters, int use_ka,
                                void* stream) {
  return crbe::launch_block_step<float, false>(
      scal, u_in, up_in, u_out, up_out, halt, nullptr, n, rows, row0, int_lo,
      int_hi, tile, halo, n_iters, use_ka, stream);
}

int crbe_uniform_block_step_f64(const double* scal, const double* u_in,
                                const double* up_in, double* u_out,
                                double* up_out, const int* halt, int n,
                                int rows, int row0, int int_lo, int int_hi,
                                int tile, int halo, int n_iters, int use_ka,
                                void* stream) {
  return crbe::launch_block_step<double, false>(
      scal, u_in, up_in, u_out, up_out, halt, nullptr, n, rows, row0, int_lo,
      int_hi, tile, halo, n_iters, use_ka, stream);
}

int crbe_uniform_block_step_load_f32(const float* scal, const float* u_in,
                                     const float* up_in, float* u_out,
                                     float* up_out, const int* halt,
                                     const float* load, int n, int rows,
                                     int row0, int int_lo, int int_hi,
                                     int tile, int halo, int n_iters,
                                     int use_ka, void* stream) {
  return crbe::launch_block_step<float, true>(
      scal, u_in, up_in, u_out, up_out, halt, load, n, rows, row0, int_lo,
      int_hi, tile, halo, n_iters, use_ka, stream);
}

int crbe_uniform_block_step_load_f64(const double* scal, const double* u_in,
                                     const double* up_in, double* u_out,
                                     double* up_out, const int* halt,
                                     const double* load, int n, int rows,
                                     int row0, int int_lo, int int_hi,
                                     int tile, int halo, int n_iters,
                                     int use_ka, void* stream) {
  return crbe::launch_block_step<double, true>(
      scal, u_in, up_in, u_out, up_out, halt, load, n, rows, row0, int_lo,
      int_hi, tile, halo, n_iters, use_ka, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
