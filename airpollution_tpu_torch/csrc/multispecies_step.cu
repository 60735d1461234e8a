// One Strang step of K species with linear chemistry, on the per-DOF
// canvas operator, with the chemistry inside the kernel; one block per 2-D
// output tile; the caller loops over steps.
//
// Replaces airpollution_tpu/ops/pallas_hbm.py::
// _canvas_multispecies_step_kernel, which streams row stripes of the
// (3K, n, n) species stack and of the shared (21, n, n) coefficient stack
// through VMEM. One step is
//
//   u_k <- sum_j E[k, j] u_j                  (first chemistry half-step,
//                                              E = expm(-dt/2 R))
//   u_k <- canvas step of u_k                 (for each species k: B4's
//                                              RHS + load, masked warm
//                                              start mask(u_k), k Chebyshev
//                                              iterations; no extrapolation)
//   u_k <- sum_j E[k, j] u_j                  (second half-step)
//
// Every species shares one transport operator (the coefficient stack of
// canvas_tile.cuh); only the state and the loads are per species.
//
// Design (canvas_tile.cuh): each thread owns a fixed set of window cells
// and reads their 18 operator values into registers once per launch, for
// all K species and all their phases; x and r of the species being solved
// stay in registers too. The first mix is pointwise in space, so applied
// to the whole window it needs no extra halo: a block loads the K species'
// windows, mixes them in registers and keeps the K x 3 mixed planes in
// shared memory (Crank-Nicolson's S u reads them across threads); it then
// solves the species one after another through canvas_tile.cuh's phases,
// d and d_next in 6 shared planes, each species' last x += d landing in its
// own mixed planes on the tile; it mixes the solved states again on the
// tile only and writes K x 3 T^2 values. Shared memory: (3K + 6) planes of
// (T + 2h)^2 cells; ops/fused_hbm.multispecies_plan picks T and the depth
// per (K, k, dtype). A deep step is split over `depth` launches as in B4,
// x, r and d of every species through a (K, 9, n, n) work buffer (two from
// depth 3 on). Dead DOFs stay exactly 0: the mix of zeros is zero, and a
// dead row of the masked operator is an identity row with zero mass and
// zero columns; the loads are zero there (ops/loads.EmissionLoads).
//
// Emission loads: the TPU kernel evaluates each species' Python source
// hook inside the kernel. A hook cannot be compiled into this kernel, so
// the caller builds each sourced species' load in torch and passes the
// loads as a stack of (3, n, n) planes; species k reads plane
// load_index[k] (-1: no source) once per cell, added to its RHS.
//
// Kernel B10 (entry points crbe_multispecies_block_step_*): the same step
// on one row block of the canvas, the counterpart of the TPU kernel's
// sharded-block mode that airpollution_tpu/parallel/hbm_shard.py launches
// per device (build_multispecies_hbm_halo_solver). It is the kBlock
// instantiation (tile_step.cuh's block mode): the coefficient stack, the
// K species' states, the loads and the work buffers are extended blocks of
// rows = local + 2 halo rows; the mixes are pointwise, so mixing the halo
// rows the caller refreshed gives exactly what the neighbouring block
// computes there, and K species share one exchange of their halo rows.
//
// What bounds it on an H100: device memory must see the coefficient stack
// once and the K species states once each way per step, plus each load:
// (21 + 6K) x n^2 x sizeof(T) + 3 n^2 sizeof(T) per sourced species,
// 176 MB at 1025^2, K=3, one load, in f32: 0.053 ms at 3.35 TB/s. Its
// ~1.5 GFLOP take 0.023 ms at 67 TFLOP/s. Each launch reads its windows'
// coefficients once for all K species ((T + 2h)^2 / T^2 times the stack);
// the parent design read them K (k + 2) times.

#include <cuda_runtime.h>

#include "canvas_tile.cuh"

namespace crbe {

constexpr int kMaxSpecies = 8;

// The species of one launch: their count and which load plane each reads.
struct Species {
  int K;
  int load_index[kMaxSpecies];
};

// out_k = sum_j E[k, j] v_j for k < K (E row-major (K, K)).
template <typename T>
__device__ __forceinline__ void mix(const T* E, int K,
                                    const T (&v)[kMaxSpecies],
                                    T (&out)[kMaxSpecies]) {
#pragma unroll
  for (int k = 0; k < kMaxSpecies; ++k) {
    if (k >= K) break;
    T acc = E[k * K] * v[0];
#pragma unroll
    for (int j = 1; j < kMaxSpecies; ++j) {
      if (j < K) acc += E[k * K + j] * v[j];
    }
    out[k] = acc;
  }
}

template <typename T, bool kLoad, bool kBlock>
__global__ void __launch_bounds__(Shape<T>::kThreads, 1)
    multispecies_step_kernel(Geometry g, Rect rc, Span span, Species sp,
                             const T* __restrict__ C, const T* scal,
                             const T* u_in, const T* loads, T* u_out,
                             const int* halt, const T* work_in,
                             T* work_out) {
  if (halt != nullptr && *halt >= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Chebyshev scalars, then E_half (K x K, row-major).
  __shared__ T s[kChebScal + kMaxSpecies * kMaxSpecies];
  const int K = sp.K;
  const int n_scal = 1 + 2 * g.n_iters + K * K;
  for (int i = threadIdx.x; i < n_scal; i += blockDim.x) s[i] = scal[i];
  const T* E = s + 1 + 2 * g.n_iters;

  const Window<kBlock> w(g, blockIdx.x);
  const int PS = w.PS;
  T* const D0 = reinterpret_cast<T*>(smem_raw);
  T* const D1 = D0 + 3 * PS;
  T* const U = D1 + 3 * PS;  // K x 3 species planes
  Cells<T, kBlock> cells(w, C);
  __syncthreads();  // the scalars

  // 1. First span: load the K species windows (zero outside the canvas)
  //    and apply the first half-mix on the whole window.
  if (span.first) {
    cells.each(0, [&](int, int wr, int wc) {
      size_t off;
      const bool inside = w.cell(wr, wc, off);
      const int q = wr * w.W + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        T v[kMaxSpecies], m[kMaxSpecies];
#pragma unroll
        for (int j = 0; j < kMaxSpecies; ++j) {
          v[j] = (j < K && inside) ? u_in[(3 * j + f) * w.nn + off] : T(0);
        }
        mix(E, K, v, m);
#pragma unroll
        for (int k = 0; k < kMaxSpecies; ++k) {
          if (k < K) U[(3 * k + f) * PS + q] = m[k];
        }
      }
    });
    __syncthreads();
  }

  // 2. The species one after another, each from its mixed planes (first
  //    span) or its work planes (later spans); the last span's x += d lands
  //    in its mixed planes on the tile. Every cell a thread reads or writes
  //    outside a matvec is its own, so the phases' barriers are the only
  //    ones needed between species.
  const size_t work_stride = 9 * w.nn;
  for (int k = 0; k < K; ++k) {
    T* X = U + 3 * k * PS;
    int lo = 0;
    if (span.first) {
      const int li = sp.load_index[k];
      const T* load = li >= 0 ? loads + static_cast<size_t>(li) * 3 * w.nn
                              : nullptr;
      cells.template rhs<kLoad>(g, rc, C, X, load, nullptr, nullptr, 0, D1);
      __syncthreads();
      lo = g.use_ka ? 2 : 1;
      cells.initial(lo, s[0], D1, D0);
    } else {
      cells.resume(work_in + k * work_stride, D0);
    }
    __syncthreads();
    const T* D = cells.iterate(s, g.n_iters, span.it0, span.it1, lo, D0, D1);
    if (span.last) {
      cells.finish(D, [&](int, int wr, int wc, int f, T v) {
        X[f * PS + wr * w.W + wc] = v;
      });
    } else {
      cells.suspend(D, work_out + k * work_stride);
    }
  }
  if (!span.last) return;

  // 3. Second half-mix on the tile, written back (its interior rows in
  //    block mode, 0 past the canvas).
  cells.each(w.h, [&](int, int wr, int wc) {
    size_t off;
    bool live;
    if (!w.store(wr, wc, off, live)) return;
    const int q = wr * w.W + wc;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      T v[kMaxSpecies], m[kMaxSpecies];
#pragma unroll
      for (int j = 0; j < kMaxSpecies; ++j) {
        v[j] = j < K ? U[(3 * j + f) * PS + q] : T(0);
      }
      mix(E, K, v, m);
#pragma unroll
      for (int k = 0; k < kMaxSpecies; ++k) {
        if (k < K) u_out[(3 * k + f) * w.nn + off] = live ? m[k] : T(0);
      }
    }
  });
}

inline size_t multispecies_smem_bytes(int tile, int halo, int K,
                                      size_t elem) {
  const size_t w = static_cast<size_t>(tile + 2 * halo);
  return (3 * static_cast<size_t>(K) + 6) * w * w * elem;
}

template <typename T, bool kLoad, bool kBlock>
int launch_multispecies_spans(const T* C, const T* scal, const T* u_in,
                              const T* loads, T* u_out, const int* halt,
                              T* work, Geometry g, Rect rc, const Species& sp,
                              int depth, void* stream) {
  if (depth > 1 && work == nullptr) return cudaErrorInvalidValue;
  auto kernel = multispecies_step_kernel<T, kLoad, kBlock>;
  static size_t smem_set = 0;
  const size_t per = 9 * static_cast<size_t>(sp.K) *
                     (kBlock ? g.rows : g.n) * g.n;
  T* bufs[2] = {work, work == nullptr ? nullptr : work + per};
  for (int j = 0; j < depth; ++j) {
    int halo;
    const Span span = make_span(g.n_iters, g.use_ka, false, depth, j, &halo);
    if (!window_fits<T>(g.tile, halo)) return cudaErrorInvalidValue;
    const Geometry gj = span_geometry<kBlock>(g, halo, span);
    const size_t smem = multispecies_smem_bytes(g.tile, halo, sp.K,
                                                sizeof(T));
    cudaError_t err = ensure_smem(kernel, smem, &smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<gj.tile_rows * gj.tiles_per_row, Shape<T>::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        gj, rc, span, sp, C, scal, u_in, loads, u_out, halt,
        j > 0 ? bufs[(j - 1) & 1] : nullptr,
        span.last ? nullptr : bufs[j & 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool kBlock>
int launch_multispecies(const T* C, const T* scal, const T* u_in,
                        const T* loads, T* u_out, const int* halt, T* work,
                        const int* load_index, int n_species, Geometry g,
                        int h_lo, int h_hi, int v_lo, int v_hi, int depth,
                        void* stream) {
  if (g.n_iters < 1 || g.n_iters > kMaxIters || g.tile < 1) {
    return cudaErrorInvalidValue;
  }
  if (!depth_fits(g.n_iters, g.use_ka, false, depth)) {
    return cudaErrorInvalidValue;
  }
  if (kBlock && !block_fits(g)) return cudaErrorInvalidValue;
  if (n_species < 1 || n_species > kMaxSpecies) return cudaErrorInvalidValue;
  Species sp;
  sp.K = n_species;
  for (int k = 0; k < kMaxSpecies; ++k) {
    sp.load_index[k] = k < n_species ? load_index[k] : -1;
    if (sp.load_index[k] >= 0 && loads == nullptr) {
      return cudaErrorInvalidValue;
    }
  }
  Rect rc{h_lo, h_hi, v_lo, v_hi};
  if (loads != nullptr) {
    return launch_multispecies_spans<T, true, kBlock>(
        C, scal, u_in, loads, u_out, halt, work, g, rc, sp, depth, stream);
  }
  return launch_multispecies_spans<T, false, kBlock>(
      C, scal, u_in, loads, u_out, halt, work, g, rc, sp, depth, stream);
}

}  // namespace crbe

extern "C" {

// load_index: a host array of n_species ints; work: 9 K n^2 values at
// depth 2, twice that from depth 3 (null at depth 1).
int crbe_multispecies_step_f32(const float* C, const float* scal,
                               const float* u_in, const float* loads,
                               float* u_out, const int* halt, float* work,
                               const int* load_index, int n_species, int n,
                               int tile, int depth, int n_iters, int use_ka,
                               int h_lo, int h_hi, int v_lo, int v_hi,
                               void* stream) {
  return crbe::launch_multispecies<float, false>(
      C, scal, u_in, loads, u_out, halt, work, load_index, n_species,
      crbe::step_geometry(n, tile, 0, n_iters, use_ka), h_lo, h_hi, v_lo,
      v_hi, depth, stream);
}

int crbe_multispecies_step_f64(const double* C, const double* scal,
                               const double* u_in, const double* loads,
                               double* u_out, const int* halt, double* work,
                               const int* load_index, int n_species, int n,
                               int tile, int depth, int n_iters, int use_ka,
                               int h_lo, int h_hi, int v_lo, int v_hi,
                               void* stream) {
  return crbe::launch_multispecies<double, false>(
      C, scal, u_in, loads, u_out, halt, work, load_index, n_species,
      crbe::step_geometry(n, tile, 0, n_iters, use_ka), h_lo, h_hi, v_lo,
      v_hi, depth, stream);
}

// Kernel B10: C is the block's (21, rows, n) stack, u_in and u_out
// (3 K, rows, n) blocks, loads (n_src, 3, rows, n), each work buffer
// (K, 9, rows, n); the rectangle bounds are global. The block's halo
// (int_lo) must cover the whole step's halo, k + use_ka.
int crbe_multispecies_block_step_f32(
    const float* C, const float* scal, const float* u_in, const float* loads,
    float* u_out, const int* halt, float* work, const int* load_index,
    int n_species, int n, int rows, int row0, int int_lo, int int_hi,
    int tile, int depth, int n_iters, int use_ka, int h_lo, int h_hi,
    int v_lo, int v_hi, void* stream) {
  return crbe::launch_multispecies<float, true>(
      C, scal, u_in, loads, u_out, halt, work, load_index, n_species,
      crbe::block_geometry(n, rows, row0, int_lo, int_hi, tile,
                           n_iters + use_ka, n_iters, use_ka),
      h_lo, h_hi, v_lo, v_hi, depth, stream);
}

int crbe_multispecies_block_step_f64(
    const double* C, const double* scal, const double* u_in,
    const double* loads, double* u_out, const int* halt, double* work,
    const int* load_index, int n_species, int n, int rows, int row0,
    int int_lo, int int_hi, int tile, int depth, int n_iters, int use_ka,
    int h_lo, int h_hi, int v_lo, int v_hi, void* stream) {
  return crbe::launch_multispecies<double, true>(
      C, scal, u_in, loads, u_out, halt, work, load_index, n_species,
      crbe::block_geometry(n, rows, row0, int_lo, int_hi, tile,
                           n_iters + use_ka, n_iters, use_ka),
      h_lo, h_hi, v_lo, v_hi, depth, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
