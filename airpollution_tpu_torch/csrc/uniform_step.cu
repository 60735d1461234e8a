// One fused CRBE time step with the uniform operator and Chebyshev
// iterations, one block per output tile; the caller loops over steps.
//
// Replaces airpollution_tpu/ops/pallas_hbm.py::_step_kernel, which streams
// row stripes of the state through VMEM with a double-buffered DMA and a
// halo of roundup8(k + 2 (+1 CN)) rows. The TPU tiles rows only, because its
// DMA wants full 128-lane rows; here each block owns a 2-D tile and takes the
// halo in both directions (every matvec reaches +-1 row and +-1 column), and
// no rounding of the halo is needed. The step itself is uniform_span
// (tile_step.cuh).
//
// What bounds it: device memory sees one read of u (and u_prev) per window
// and one write per tile, about 2 x 3 x n^2 x sizeof(T) per carried state
// and step; the arithmetic, k + 1 stencil applications over the shrinking
// window, runs from registers and shared memory (tile_step.cuh: each
// thread owns its window cells' x and r, only d crosses threads) and is the
// larger cost at k = 8, so the device-memory traffic does not grow with k.
// The tile (th x tw) and the depth (a step deeper than the registers hold
// runs as `depth` launches, x, r and d through a work buffer of 9 planes,
// two from depth 3 on) come from the caller's plan
// (ops/fused_solver.uniform_plan: one cost rule, waves of tiles times the
// cell steps of a thread, at every shape).
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
// d local - halo). It is the kBlock instantiation of uniform_span (see
// tile_step.cuh): the grid covers the interior tiles of an extended block
// of rows = local + 2 halo rows, the masks use global rows, and only the
// interior is written. One launch per block and step; device memory sees
// the extended block's state (and load) once and the interior once, so the
// halo rows add 2 halo / local to the whole-canvas step's traffic.

#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace crbe {

template <int P, typename T, bool kLoad, bool kBlock>
__global__ void __launch_bounds__(UniformShape<T>::kThreads, 1)
    uniform_step_kernel(Tiling t, Span sp, const T* scal, StepIO<T> io,
                        const int* halt, const T* work_in, T* work_out) {
  if (halt != nullptr && *halt >= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s[kMaxScal];
  load_scalars(scal, s, t.n_iters);
  const Coefs<T> k = load_coefs(s);
  uniform_span<UniformShape<T>::kThreads, P, T, kLoad, kBlock>(
      t, sp, s, k, io, work_in, work_out, blockIdx.x,
      reinterpret_cast<T*>(smem_raw));
}

// The spans of one step: `depth` launches in stream order, the work planes
// of span j read by span j + 1 (two buffers of 9 planes alternate from
// depth 3 on: a span never writes the buffer its own windows read). The
// arrays hold `rows` rows (the whole canvas: n) and the step writes rows
// [int_lo, int_hi).
template <typename T, bool kLoad, bool kBlock>
int launch_spans(const T* scal, const StepIO<T>& io, const int* halt,
                 T* work, int n, int rows, int row0, int int_lo, int int_hi,
                 int th, int tw, int depth, int n_iters, int use_ka,
                 void* stream) {
  if (!uniform_fits(kBlock, n, rows, row0, int_lo, int_hi, th, tw, n_iters,
                    use_ka, depth)) {
    return cudaErrorInvalidValue;
  }
  if (kLoad && io.load == nullptr) return cudaErrorInvalidValue;
  if (depth > 1 && work == nullptr) return cudaErrorInvalidValue;
  int halo0;
  make_span(n_iters, use_ka, false, depth, 0, &halo0);
  return with_cells<T>(window_cells<T>(th, tw, halo0), [&](auto cells) {
    constexpr int P = decltype(cells)::value;
    auto kernel = uniform_step_kernel<P, T, kLoad, kBlock>;
    static size_t smem_set = 0;
    const size_t plane = static_cast<size_t>(rows) * n;
    T* bufs[2] = {work, work == nullptr ? nullptr : work + 9 * plane};
    for (int j = 0; j < depth; ++j) {
      Span sp;
      const Tiling t = span_tiling(kBlock, n, rows, row0, int_lo, int_hi,
                                   th, tw, n_iters, use_ka, depth, j, &sp);
      const size_t smem = uniform_smem_bytes(th, tw, t.halo, sizeof(T));
      cudaError_t err = ensure_smem(kernel, smem, &smem_set);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<t.tile_rows * t.tiles_per_row, UniformShape<T>::kThreads,
               smem, static_cast<cudaStream_t>(stream)>>>(
          t, sp, scal, io, halt, j > 0 ? bufs[(j - 1) & 1] : nullptr,
          sp.last ? nullptr : bufs[j & 1]);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
  });
}

template <typename T>
StepIO<T> step_io(const T* u_in, const T* up_in, T* u_out, T* up_out,
                  const T* load) {
  StepIO<T> io;
  io.u_in = u_in;
  io.up_in = up_in;
  io.u_out = u_out;
  io.up_out = up_out;
  io.load = load;
  return io;
}

template <typename T, bool kLoad>
int launch_step(const T* scal, const T* u_in, const T* up_in, T* u_out,
                T* up_out, const int* halt, const T* load, T* work, int n,
                int th, int tw, int depth, int n_iters, int use_ka,
                void* stream) {
  return launch_spans<T, kLoad, false>(
      scal, step_io(u_in, up_in, u_out, up_out, load), halt, work, n, n, 0,
      0, n, th, tw, depth, n_iters, use_ka, stream);
}

template <typename T, bool kLoad>
int launch_block_step(const T* scal, const T* u_in, const T* up_in, T* u_out,
                      T* up_out, const int* halt, const T* load, T* work,
                      int n, int rows, int row0, int int_lo, int int_hi,
                      int th, int tw, int depth, int n_iters, int use_ka,
                      void* stream) {
  return launch_spans<T, kLoad, true>(
      scal, step_io(u_in, up_in, u_out, up_out, load), halt, work, n, rows,
      row0, int_lo, int_hi, th, tw, depth, n_iters, use_ka, stream);
}

}  // namespace crbe

// Every entry point takes the plan's tile rows and columns (th, tw) and
// depth; work holds 9 planes of the arrays' shape at depth 2, 18 from depth
// 3 (null at depth 1).
extern "C" {

int crbe_uniform_step_f32(const float* scal, const float* u_in,
                          const float* up_in, float* u_out, float* up_out,
                          const int* halt, float* work, int n, int th,
                          int tw, int depth, int n_iters, int use_ka,
                          void* stream) {
  return crbe::launch_step<float, false>(scal, u_in, up_in, u_out, up_out,
                                         halt, nullptr, work, n, th, tw,
                                         depth, n_iters, use_ka, stream);
}

int crbe_uniform_step_f64(const double* scal, const double* u_in,
                          const double* up_in, double* u_out, double* up_out,
                          const int* halt, double* work, int n, int th,
                          int tw, int depth, int n_iters, int use_ka,
                          void* stream) {
  return crbe::launch_step<double, false>(scal, u_in, up_in, u_out, up_out,
                                          halt, nullptr, work, n, th, tw,
                                          depth, n_iters, use_ka, stream);
}

int crbe_uniform_step_load_f32(const float* scal, const float* u_in,
                               const float* up_in, float* u_out,
                               float* up_out, const int* halt,
                               const float* load, float* work, int n, int th,
                               int tw, int depth, int n_iters, int use_ka,
                               void* stream) {
  return crbe::launch_step<float, true>(scal, u_in, up_in, u_out, up_out,
                                        halt, load, work, n, th, tw, depth,
                                        n_iters, use_ka, stream);
}

int crbe_uniform_step_load_f64(const double* scal, const double* u_in,
                               const double* up_in, double* u_out,
                               double* up_out, const int* halt,
                               const double* load, double* work, int n,
                               int th, int tw, int depth, int n_iters,
                               int use_ka, void* stream) {
  return crbe::launch_step<double, true>(scal, u_in, up_in, u_out, up_out,
                                         halt, load, work, n, th, tw, depth,
                                         n_iters, use_ka, stream);
}

// Kernel B8: u_in, up_in, u_out, up_out, load and the work planes are
// (3, rows, n) blocks (the work planes (9, rows, n) per set).
int crbe_uniform_block_step_f32(const float* scal, const float* u_in,
                                const float* up_in, float* u_out,
                                float* up_out, const int* halt, float* work,
                                int n, int rows, int row0, int int_lo,
                                int int_hi, int th, int tw, int depth,
                                int n_iters, int use_ka, void* stream) {
  return crbe::launch_block_step<float, false>(
      scal, u_in, up_in, u_out, up_out, halt, nullptr, work, n, rows, row0,
      int_lo, int_hi, th, tw, depth, n_iters, use_ka, stream);
}

int crbe_uniform_block_step_f64(const double* scal, const double* u_in,
                                const double* up_in, double* u_out,
                                double* up_out, const int* halt,
                                double* work, int n, int rows, int row0,
                                int int_lo, int int_hi, int th, int tw,
                                int depth, int n_iters, int use_ka,
                                void* stream) {
  return crbe::launch_block_step<double, false>(
      scal, u_in, up_in, u_out, up_out, halt, nullptr, work, n, rows, row0,
      int_lo, int_hi, th, tw, depth, n_iters, use_ka, stream);
}

int crbe_uniform_block_step_load_f32(const float* scal, const float* u_in,
                                     const float* up_in, float* u_out,
                                     float* up_out, const int* halt,
                                     const float* load, float* work, int n,
                                     int rows, int row0, int int_lo,
                                     int int_hi, int th, int tw, int depth,
                                     int n_iters, int use_ka, void* stream) {
  return crbe::launch_block_step<float, true>(
      scal, u_in, up_in, u_out, up_out, halt, load, work, n, rows, row0,
      int_lo, int_hi, th, tw, depth, n_iters, use_ka, stream);
}

int crbe_uniform_block_step_load_f64(const double* scal, const double* u_in,
                                     const double* up_in, double* u_out,
                                     double* up_out, const int* halt,
                                     const double* load, double* work, int n,
                                     int rows, int row0, int int_lo,
                                     int int_hi, int th, int tw, int depth,
                                     int n_iters, int use_ka, void* stream) {
  return crbe::launch_block_step<double, true>(
      scal, u_in, up_in, u_out, up_out, halt, load, work, n, rows, row0,
      int_lo, int_hi, th, tw, depth, n_iters, use_ka, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
