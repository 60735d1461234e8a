// One fused CRBE time step with the per-DOF canvas operator and Chebyshev
// iterations, one block per 2-D output tile; the caller loops over steps.
//
// Replaces airpollution_tpu/ops/pallas_hbm.py::_canvas_step_kernel
// (raw_b=False), which streams row stripes of the state and of a
// (21, n, n) coefficient stack through VMEM with a double-buffered DMA.
// The step is that of uniform_step.cu (tile_step.cuh), with the operator
// read per DOF (canvas_tile.cuh) instead of from 22 scalars:
//
//   b  = M u                                  (backward Euler)
//   b  = 2 M u + (1 - mask) u - S u           (Crank-Nicolson, on the
//                                              unmasked state)
//   b += load                                 (optional emission load)
//   x  = mask(2 u - u_prev) or mask(u)        (warm start)
//   r  = b - S x;  d = (id r) / theta
//   k times: x += d; r -= S d; d = a_k d + b_k (id r)
//
// The TPU kernel evaluates a Python source hook inside the kernel; a hook
// cannot be compiled into this kernel, so the caller builds the load in
// torch (ops/loads.EmissionLoads) and passes it as one (3, n, n)
// plane, read once per cell. A null load is the source-free step.
//
// `mask` is the family interior rectangle, widened by Robin walls
// (rect = h_lo, h_hi, v_lo, v_hi; ops/fused_hbm.robin_rect_bounds).
// Obstacle dead DOFs need nothing here: they are identity rows with zero
// mass and zero columns, so a state that enters as 0 there stays exactly 0.
//
// Design (canvas_tile.cuh): each thread owns a fixed set of window cells
// and holds their 18 operator values, x and r in registers for the whole
// launch; shared memory holds only d and d_next (6 planes of the window;
// Crank-Nicolson's state u shares the first two). A step whose window
// would not fit the registers is split over `depth` launches (spans), with
// x, r and d through a work buffer of 9 planes (two buffers from depth 3
// on); ops/fused_hbm.canvas_plan picks the tile and depth per (mode, k,
// dtype). The load is a template parameter: a run-time test for it cost
// ~5% on an H100 in the first design.
//
// Raw mode (kRaw, the entry points crbe_canvas_step_raw_*): the TPU
// kernel's raw_b=True, the primal and adjoint solve of the differentiable
// fused engine (ops/fused_hbm.chebyshev_apply_canvas_hbm). The input is
// the right-hand side b itself and the step is the bare Jacobi-
// preconditioned Chebyshev polynomial from a zero start, p(A) mask(b):
//
//   r  = mask b;  x = 0;  d = (id r) / theta
//   k times: x += d; r -= S d; d = a_k d + b_k (id r)
//
// no mass read, no u_prev, no load. Since x0 = 0 the matvec on it is
// skipped, so S is applied k - 1 times and the halo is k - 1. Only the
// input is masked, in the first span: nothing inside the iterations, in a
// later span or on the output is, because over the transposed coefficients
// (ops/stencil.transpose_coefficients) the Dirichlet rows carry A's
// Dirichlet columns and p(A^T) b is not zero there. The mass planes of C
// are unused (zero).
//
// Kernel B9 (entry points crbe_canvas_block_step_*, the load optional as in
// B4): the same step on one row block of the canvas, the counterpart of the
// TPU kernel's sharded-block mode that airpollution_tpu/parallel/
// hbm_shard.py launches per device (build_canvas_hbm_halo_solver). It is
// the kBlock instantiation (tile_step.cuh's block mode): C, the state, the
// load and the work buffer are extended blocks of rows = local + 2 halo
// rows, whose coefficient rows the caller extends once per solve with its
// neighbours' (zero at the chain ends); the Robin-widened rectangle bounds
// are global, as are the masks, and only the interior rows are written.
//
// What bounds it on an H100: device memory must see the coefficient stack
// once and the state once each way per step: (21 + 4 x 3) x n^2 x
// sizeof(T), 138.7 MB at 1025^2 in f32, 0.041 ms at 3.35 TB/s (3 more
// planes with a load). Each span reads its windows' 21 (later spans 18)
// coefficient planes once, (T + 2h)^2 / T^2 times the stack, and a split
// adds 9 planes each way per extra span; see canvas_tile.cuh.

#include <cuda_runtime.h>

#include "canvas_tile.cuh"

namespace crbe {

template <typename T, bool kLoad, bool kRaw, bool kBlock>
__global__ void __launch_bounds__(Shape<T>::kThreads, 1)
    canvas_step_kernel(Geometry g, Rect rc, Span sp,
                       const T* __restrict__ C, const T* scal,
                       const T* u_in, const T* up_in, T* u_out, T* up_out,
                       const int* halt, const T* load, const T* work_in,
                       T* work_out) {
  if (halt != nullptr && *halt >= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s[kChebScal];
  for (int i = threadIdx.x; i < 1 + 2 * g.n_iters; i += blockDim.x) {
    s[i] = scal[i];
  }
  const Window<kBlock> w(g, blockIdx.x);
  T* const D0 = reinterpret_cast<T*>(smem_raw);
  T* const D1 = D0 + 3 * w.PS;
  Cells<T, kBlock> cells(w, C);
  __syncthreads();  // the scalars
  const T inv_theta = s[0];

  // The start: the right-hand side, warm start and initial residual, raw
  // mode's r = mask b, or a later span's x, r and d. d ends in D0.
  int lo = 0;
  if (!sp.first) {
    cells.resume(work_in, D0);
  } else if constexpr (kRaw) {
    cells.raw_start(rc, u_in, inv_theta, D0);
  } else {
    // The state window in D0 (zero off the canvas), for the right-hand
    // side's S u; the warm start goes to D1, the first d back to D0.
    cells.each(0, [&](int, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      const int q = wr * w.W + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        D0[f * w.PS + q] = on ? u_in[f * w.nn + off] : T(0);
      }
    });
    __syncthreads();
    cells.template rhs<kLoad>(g, rc, C, D0, load, up_in, up_out, sp.ext,
                              D1);
    __syncthreads();
    lo = g.use_ka ? 2 : 1;
    cells.initial(lo, inv_theta, D1, D0);
  }
  __syncthreads();

  const T* D = cells.iterate(s, g.n_iters, sp.it0, sp.it1, lo, D0, D1);

  // The end: the last x += d on the tile, written back (its interior rows
  // in block mode, 0 past the canvas), or x, r, d to the work planes.
  if (sp.last) {
    cells.finish(D, [&](int, int wr, int wc, int f, T v) {
      size_t off;
      bool live;
      if (w.store(wr, wc, off, live)) u_out[f * w.nn + off] = live ? v : T(0);
    });
  } else {
    cells.suspend(D, work_out);
  }
}

inline size_t canvas_smem_bytes(int tile, int halo, size_t elem) {
  const size_t w = static_cast<size_t>(tile + 2 * halo);
  return 6 * w * w * elem;
}

// The spans of one step: `depth` launches in stream order, the work planes
// of span j read by span j + 1 (two buffers of 9 planes alternate from
// depth 3 on: a span never writes the buffer its own windows read).
template <typename T, bool kLoad, bool kRaw, bool kBlock>
int launch_spans(const T* C, const T* scal, const T* u_in, const T* up_in,
                 T* u_out, T* up_out, const int* halt, const T* load,
                 T* work, Geometry g, Rect rc, int depth, void* stream) {
  if (g.tile < 1 || !depth_fits(g.n_iters, g.use_ka, kRaw, depth)) {
    return cudaErrorInvalidValue;
  }
  if (depth > 1 && work == nullptr) return cudaErrorInvalidValue;
  auto kernel = canvas_step_kernel<T, kLoad, kRaw, kBlock>;
  static size_t smem_set = 0;
  const size_t plane = static_cast<size_t>(kBlock ? g.rows : g.n) * g.n;
  T* bufs[2] = {work, work == nullptr ? nullptr : work + 9 * plane};
  for (int j = 0; j < depth; ++j) {
    int halo;
    const Span sp = make_span(g.n_iters, g.use_ka, kRaw, depth, j, &halo);
    if (!window_fits<T>(g.tile, halo)) return cudaErrorInvalidValue;
    const Geometry gj = span_geometry<kBlock>(g, halo, sp);
    const size_t smem = canvas_smem_bytes(g.tile, halo, sizeof(T));
    cudaError_t err = ensure_smem(kernel, smem, &smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<gj.tile_rows * gj.tiles_per_row, Shape<T>::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        gj, rc, sp, C, scal, u_in, up_in, u_out, up_out, halt, load,
        j > 0 ? bufs[(j - 1) & 1] : nullptr, sp.last ? nullptr : bufs[j & 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool kBlock>
int launch_canvas(const T* C, const T* scal, const T* u_in, const T* up_in,
                  T* u_out, T* up_out, const int* halt, const T* load,
                  T* work, Geometry g, Rect rc, int depth, void* stream) {
  if (g.n_iters < 1 || g.n_iters > kMaxIters) return cudaErrorInvalidValue;
  if (kBlock && !block_fits(g)) return cudaErrorInvalidValue;
  if (load != nullptr) {
    return launch_spans<T, true, false, kBlock>(C, scal, u_in, up_in, u_out,
                                                up_out, halt, load, work, g,
                                                rc, depth, stream);
  }
  return launch_spans<T, false, false, kBlock>(C, scal, u_in, up_in, u_out,
                                               up_out, halt, load, work, g,
                                               rc, depth, stream);
}

}  // namespace crbe

extern "C" {

// Raw mode: x_out = p(A) mask(b), (3, n, n) each; work: 9 n^2 values at
// depth 2, 18 n^2 from depth 3 (null at depth 1).
int crbe_canvas_step_raw_f32(const float* C, const float* scal,
                             const float* b, float* x_out, float* work, int n,
                             int tile, int depth, int n_iters, int h_lo,
                             int h_hi, int v_lo, int v_hi, void* stream) {
  if (n_iters < 1 || n_iters > crbe::kMaxIters) return cudaErrorInvalidValue;
  return crbe::launch_spans<float, false, true, false>(
      C, scal, b, nullptr, x_out, nullptr, nullptr, nullptr, work,
      crbe::step_geometry(n, tile, 0, n_iters, 0),
      crbe::Rect{h_lo, h_hi, v_lo, v_hi}, depth, stream);
}

int crbe_canvas_step_raw_f64(const double* C, const double* scal,
                             const double* b, double* x_out, double* work,
                             int n, int tile, int depth, int n_iters,
                             int h_lo, int h_hi, int v_lo, int v_hi,
                             void* stream) {
  if (n_iters < 1 || n_iters > crbe::kMaxIters) return cudaErrorInvalidValue;
  return crbe::launch_spans<double, false, true, false>(
      C, scal, b, nullptr, x_out, nullptr, nullptr, nullptr, work,
      crbe::step_geometry(n, tile, 0, n_iters, 0),
      crbe::Rect{h_lo, h_hi, v_lo, v_hi}, depth, stream);
}

int crbe_canvas_step_f32(const float* C, const float* scal, const float* u_in,
                         const float* up_in, float* u_out, float* up_out,
                         const int* halt, const float* load, float* work,
                         int n, int tile, int depth, int n_iters, int use_ka,
                         int h_lo, int h_hi, int v_lo, int v_hi,
                         void* stream) {
  return crbe::launch_canvas<float, false>(
      C, scal, u_in, up_in, u_out, up_out, halt, load, work,
      crbe::step_geometry(n, tile, 0, n_iters, use_ka),
      crbe::Rect{h_lo, h_hi, v_lo, v_hi}, depth, stream);
}

int crbe_canvas_step_f64(const double* C, const double* scal,
                         const double* u_in, const double* up_in,
                         double* u_out, double* up_out, const int* halt,
                         const double* load, double* work, int n, int tile,
                         int depth, int n_iters, int use_ka, int h_lo,
                         int h_hi, int v_lo, int v_hi, void* stream) {
  return crbe::launch_canvas<double, false>(
      C, scal, u_in, up_in, u_out, up_out, halt, load, work,
      crbe::step_geometry(n, tile, 0, n_iters, use_ka),
      crbe::Rect{h_lo, h_hi, v_lo, v_hi}, depth, stream);
}

// Kernel B9: C is the block's (21, rows, n) stack, the state, the load and
// each work buffer (3, rows, n) / (9, rows, n) blocks; the rectangle
// bounds are global. The block's halo (int_lo) must cover the whole step's
// halo, k + use_ka.
int crbe_canvas_block_step_f32(const float* C, const float* scal,
                               const float* u_in, const float* up_in,
                               float* u_out, float* up_out, const int* halt,
                               const float* load, float* work, int n,
                               int rows, int row0, int int_lo, int int_hi,
                               int tile, int depth, int n_iters, int use_ka,
                               int h_lo, int h_hi, int v_lo, int v_hi,
                               void* stream) {
  return crbe::launch_canvas<float, true>(
      C, scal, u_in, up_in, u_out, up_out, halt, load, work,
      crbe::block_geometry(n, rows, row0, int_lo, int_hi, tile,
                           n_iters + use_ka, n_iters, use_ka),
      crbe::Rect{h_lo, h_hi, v_lo, v_hi}, depth, stream);
}

int crbe_canvas_block_step_f64(const double* C, const double* scal,
                               const double* u_in, const double* up_in,
                               double* u_out, double* up_out,
                               const int* halt, const double* load,
                               double* work, int n, int rows, int row0,
                               int int_lo, int int_hi, int tile, int depth,
                               int n_iters, int use_ka, int h_lo, int h_hi,
                               int v_lo, int v_hi, void* stream) {
  return crbe::launch_canvas<double, true>(
      C, scal, u_in, up_in, u_out, up_out, halt, load, work,
      crbe::block_geometry(n, rows, row0, int_lo, int_hi, tile,
                           n_iters + use_ka, n_iters, use_ka),
      crbe::Rect{h_lo, h_hi, v_lo, v_hi}, depth, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
