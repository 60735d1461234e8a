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
// Shape: canvas_step.cu's shrinking squares with the halo h = k (+1
// Crank-Nicolson). The first mix is pointwise in space, so applied to the
// whole window it needs no extra halo. A block loads the K species'
// windows, mixes them in registers and keeps the K x 3 mixed planes in
// shared memory; it then solves the species one after another, each in
// its own planes (x starts as the mixed state, which CN's S u reads
// unmasked) with three shared r, d and d_next planes; it mixes the solved
// states again on the tile only and writes K x 3 T^2 values. Shared
// memory: (3K + 9) planes of (T + 2h)^2 cells, 180 KB at K=3, k=8, CN,
// T=32 in f32 (T=16 in f64: 166 KB); ops/fused_hbm picks T per (K, k,
// dtype). Dead DOFs stay exactly 0: the mix of zeros is zero, and a dead
// row of the masked operator is an identity row with zero mass and zero
// columns; the loads are zero there (ops/loads.EmissionLoads).
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
// K species' states and the loads are extended blocks of rows = local +
// 2 halo rows; the mixes are pointwise, so mixing the halo rows the caller
// refreshed gives exactly what the neighbouring block computes there, and
// K species share one exchange of their halo rows.
//
// What bounds it on an H100: device memory must see the coefficient stack
// once and the K species states once each way per step, plus each load:
// (21 + 6K) x n^2 x sizeof(T) + 3 n^2 sizeof(T) per sourced species,
// 176 MB at 1025^2, K=3, one load, in f32: 0.053 ms at 3.35 TB/s. Its
// ~1.5 GFLOP take 0.023 ms at 67 TFLOP/s. As in B4, each cell reads its
// coefficients through __ldg in every phase, now K times per step, so
// L1 / L2 traffic, not device memory, is the likely limit of this simple
// design.

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

template <int NT, typename T, bool kLoad, bool kBlock>
__global__ void __launch_bounds__(NT)
    multispecies_step_kernel(Geometry g, Rect rc, Species sp,
                             const T* __restrict__ C, const T* scal,
                             const T* u_in, const T* loads, T* u_out,
                             const int* halt) {
  if (halt != nullptr && *halt >= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Chebyshev scalars, then E_half (K x K, row-major).
  __shared__ T s[kChebScal + kMaxSpecies * kMaxSpecies];
  const int K = sp.K;
  const int n_scal = 1 + 2 * g.n_iters + K * K;
  for (int i = threadIdx.x; i < n_scal; i += NT) s[i] = scal[i];
  __syncthreads();
  const T* E = s + 1 + 2 * g.n_iters;

  const Window<kBlock> w(g, blockIdx.x);
  const int PS = w.PS;
  T* U = reinterpret_cast<T*>(smem_raw);  // K x 3 species planes
  T* R = U + 3 * K * PS;

  // 1. Load the K species windows (zero outside the canvas) and apply the
  //    first half-mix on the whole window.
  for_square<NT>(w.W, 0, [&](int wr, int wc) {
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

  // 2. Solve the species one after another, each in its own planes; the
  //    last x += d lands on the tile in place.
  for (int k = 0; k < K; ++k) {
    T* X = U + 3 * k * PS;
    const int li = sp.load_index[k];
    const T* load = li >= 0 ? loads + static_cast<size_t>(li) * 3 * w.nn
                            : nullptr;
    const T* Dc = canvas_solve<NT, kLoad>(g, w, rc, C, s, X, R, R + 3 * PS,
                                          R + 6 * PS, load);
    for_square<NT>(w.W, w.h, [&](int wr, int wc) {
      const int q = wr * w.W + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) X[f * PS + q] += Dc[f * PS + q];
    });
    __syncthreads();  // the next species reuses R, d and d_next
  }

  // 3. Second half-mix on the tile, written back (its interior rows in
  //    block mode, 0 past the canvas).
  for_square<NT>(w.W, w.h, [&](int wr, int wc) {
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

template <int NT, typename T, bool kLoad, bool kBlock>
int launch_multispecies_as(const T* C, const T* scal, const T* u_in,
                           const T* loads, T* u_out, const int* halt,
                           Geometry g, Rect rc, const Species& sp,
                           void* stream) {
  const size_t w = static_cast<size_t>(g.tile + 2 * g.halo);
  const size_t smem = (3 * sp.K + 9) * w * w * sizeof(T);
  static size_t smem_set = 0;
  cudaError_t err =
      ensure_smem(multispecies_step_kernel<NT, T, kLoad, kBlock>, smem,
                  &smem_set);
  if (err != cudaSuccess) return err;
  multispecies_step_kernel<NT, T, kLoad, kBlock>
      <<<g.tile_rows * g.tiles_per_row, NT, smem,
         static_cast<cudaStream_t>(stream)>>>(g, rc, sp, C, scal, u_in,
                                              loads, u_out, halt);
  return cudaGetLastError();
}

// Source-free launches take the instantiation without the load test.
template <int NT, typename T, bool kBlock>
int launch_multispecies_nt(const T* C, const T* scal, const T* u_in,
                           const T* loads, T* u_out, const int* halt,
                           Geometry g, Rect rc, const Species& sp,
                           void* stream) {
  if (loads != nullptr) {
    return launch_multispecies_as<NT, T, true, kBlock>(
        C, scal, u_in, loads, u_out, halt, g, rc, sp, stream);
  }
  return launch_multispecies_as<NT, T, false, kBlock>(
      C, scal, u_in, loads, u_out, halt, g, rc, sp, stream);
}

template <typename T, bool kBlock>
int launch_multispecies(const T* C, const T* scal, const T* u_in,
                        const T* loads, T* u_out, const int* halt,
                        const int* load_index, int n_species, Geometry g,
                        int h_lo, int h_hi, int v_lo, int v_hi, int threads,
                        void* stream) {
  if (g.n_iters < 1 || g.n_iters > kMaxIters) return cudaErrorInvalidValue;
  if (g.halo < g.n_iters + (g.use_ka ? 1 : 0)) return cudaErrorInvalidValue;
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
  if (threads == 512) {
    return launch_multispecies_nt<512, T, kBlock>(C, scal, u_in, loads, u_out,
                                                  halt, g, rc, sp, stream);
  }
  if constexpr (!kBlock) {
    if (threads == 256) {
      return launch_multispecies_nt<256, T, false>(C, scal, u_in, loads,
                                                   u_out, halt, g, rc, sp,
                                                   stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace crbe

extern "C" {

// load_index: a host array of n_species ints.
int crbe_multispecies_step_f32(const float* C, const float* scal,
                               const float* u_in, const float* loads,
                               float* u_out, const int* halt,
                               const int* load_index, int n_species, int n,
                               int tile, int halo, int n_iters, int use_ka,
                               int h_lo, int h_hi, int v_lo, int v_hi,
                               int threads, void* stream) {
  return crbe::launch_multispecies<float, false>(
      C, scal, u_in, loads, u_out, halt, load_index, n_species,
      crbe::step_geometry(n, tile, halo, n_iters, use_ka), h_lo, h_hi, v_lo,
      v_hi, threads, stream);
}

int crbe_multispecies_step_f64(const double* C, const double* scal,
                               const double* u_in, const double* loads,
                               double* u_out, const int* halt,
                               const int* load_index, int n_species, int n,
                               int tile, int halo, int n_iters, int use_ka,
                               int h_lo, int h_hi, int v_lo, int v_hi,
                               int threads, void* stream) {
  return crbe::launch_multispecies<double, false>(
      C, scal, u_in, loads, u_out, halt, load_index, n_species,
      crbe::step_geometry(n, tile, halo, n_iters, use_ka), h_lo, h_hi, v_lo,
      v_hi, threads, stream);
}

// Kernel B10: C is the block's (21, rows, n) stack, u_in and u_out
// (3 K, rows, n) blocks, loads (n_src, 3, rows, n); the rectangle bounds
// are global.
int crbe_multispecies_block_step_f32(
    const float* C, const float* scal, const float* u_in, const float* loads,
    float* u_out, const int* halt, const int* load_index, int n_species,
    int n, int rows, int row0, int int_lo, int int_hi, int tile, int halo,
    int n_iters, int use_ka, int h_lo, int h_hi, int v_lo, int v_hi,
    void* stream) {
  return crbe::launch_multispecies<float, true>(
      C, scal, u_in, loads, u_out, halt, load_index, n_species,
      crbe::block_geometry(n, rows, row0, int_lo, int_hi, tile, halo,
                           n_iters, use_ka),
      h_lo, h_hi, v_lo, v_hi, crbe::kBlockThreads, stream);
}

int crbe_multispecies_block_step_f64(
    const double* C, const double* scal, const double* u_in,
    const double* loads, double* u_out, const int* halt,
    const int* load_index, int n_species, int n, int rows, int row0,
    int int_lo, int int_hi, int tile, int halo, int n_iters, int use_ka,
    int h_lo, int h_hi, int v_lo, int v_hi, void* stream) {
  return crbe::launch_multispecies<double, true>(
      C, scal, u_in, loads, u_out, halt, load_index, n_species,
      crbe::block_geometry(n, rows, row0, int_lo, int_hi, tile, halo,
                           n_iters, use_ka),
      h_lo, h_hi, v_lo, v_hi, crbe::kBlockThreads, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
