// Pieces of the per-DOF canvas step kernels: canvas_step.cu (one species,
// kernel B4; its block mode B9) and multispecies_step.cu (K species with
// in-kernel chemistry, kernel B6; its block mode B10). Both run
// tile_step.cuh's shrinking squares with the operator read per DOF from a
// (21, n, n) stack (block mode: the block's (21, rows, n) rows):
//
//   C[0..14]   the 15 stencil coefficients of the MASKED system
//              (identity rows on Dirichlet and dead DOFs, zero outside each
//              family's rows), so a matvec needs no rectangle mask;
//   C[15..17]  the masked mass M (zero on Dirichlet and dead rows);
//   C[18..20]  the inverse system diagonal.

#pragma once

#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace crbe {

// Chebyshev scalar block: 1/theta, a_0..a_{k-1}, b_0..b_{k-1}.
constexpr int kChebScal = 1 + 2 * kMaxIters;

struct Rect {
  int h_lo, h_hi, v_lo, v_hi;
};

// Family interior masks at canvas cell (gr, gc), widened by Robin walls:
// H rows [h_lo, h_hi) x cols [0, c); V rows [0, c) x cols [v_lo, v_hi);
// D [0, c)^2.
template <typename T>
__device__ __forceinline__ void rect_masks(int gr, int gc, int c,
                                           const Rect& rc, T m[3]) {
  const bool r_in = gr >= 0 && gr < c;
  const bool c_in = gc >= 0 && gc < c;
  m[0] = (gr >= rc.h_lo && gr < rc.h_hi && c_in) ? T(1) : T(0);
  m[1] = (r_in && gc >= rc.v_lo && gc < rc.v_hi) ? T(1) : T(0);
  m[2] = (r_in && c_in) ? T(1) : T(0);
}

// y = S x at window index q, canvas offset `off` (the 15 coefficients read
// from device memory; 0 for a cell outside the canvas).
template <typename T>
__device__ __forceinline__ void apply_canvas(const T* __restrict__ C,
                                             size_t nn, size_t off,
                                             bool inside, const T* P, int q,
                                             int W, int PS, T y[3]) {
  if (!inside) {
    y[0] = y[1] = y[2] = T(0);
    return;
  }
  const T* H = P;
  const T* V = P + PS;
  const T* D = P + 2 * PS;
  const T h0 = H[q], hl = H[q - 1], hd = H[q + W];
  const T v0 = V[q], vr = V[q + 1], vu = V[q - W];
  const T d0 = D[q], dl = D[q - 1], du = D[q - W];
  const T* c = C + off;
  y[0] = __ldg(c) * h0 + __ldg(c + nn) * vr + __ldg(c + 2 * nn) * d0 +
         __ldg(c + 3 * nn) * vu + __ldg(c + 4 * nn) * du;
  y[1] = __ldg(c + 5 * nn) * v0 + __ldg(c + 6 * nn) * dl +
         __ldg(c + 7 * nn) * hl + __ldg(c + 8 * nn) * hd +
         __ldg(c + 9 * nn) * d0;
  y[2] = __ldg(c + 10 * nn) * d0 + __ldg(c + 11 * nn) * vr +
         __ldg(c + 12 * nn) * h0 + __ldg(c + 13 * nn) * hd +
         __ldg(c + 14 * nn) * v0;
}

// Raises a kernel's dynamic shared-memory limit to `smem` bytes when a
// launch needs more than the last one (the attribute is per kernel).
template <typename K>
inline cudaError_t ensure_smem(K kernel, size_t smem, size_t* smem_set) {
  if (smem <= *smem_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *smem_set = smem;
  return err;
}

// The window of one output tile: a (tile + 2 halo)^2 square of cells whose
// top-left cell is (r0, c0) of the arrays and global canvas row g0. In
// block mode (kBlock, tile_step.cuh) the arrays are an extended block of
// `rows` rows starting at global row g.row0 and the tiles cover its
// interior rows [g.int_lo, int_hi); otherwise array and canvas rows
// coincide.
template <bool kBlock = false>
struct Window {
  int n, c, h, W, PS, rows, int_hi, r0, g0, c0;
  size_t nn;

  __device__ Window(const Geometry& g, int tile_id)
      : n(g.n), c(g.n - 1), h(g.halo), W(g.tile + 2 * g.halo),
        PS((g.tile + 2 * g.halo) * (g.tile + 2 * g.halo)),
        rows(kBlock ? g.rows : g.n), int_hi(kBlock ? g.int_hi : g.n),
        r0((kBlock ? g.int_lo : 0) + (tile_id / g.tiles_per_row) * g.tile -
           g.halo),
        g0((kBlock ? g.row0 : 0) + r0),
        c0((tile_id % g.tiles_per_row) * g.tile - g.halo),
        nn(static_cast<size_t>(rows) * g.n) {}

  // Whether window cell (wr, wc) holds a canvas cell of the arrays, and its
  // offset there.
  __device__ __forceinline__ bool cell(int wr, int wc, size_t& off) const {
    const int br = r0 + wr, gr = g0 + wr, gc = c0 + wc;
    const bool inside = (!kBlock || (br >= 0 && br < rows)) && gr >= 0 &&
                        gr < n && gc >= 0 && gc < n;
    off = inside ? static_cast<size_t>(br) * n + gc : 0;
    return inside;
  }

  // Whether window cell (wr, wc) is written back: an interior cell of the
  // arrays; `off` its offset, `live` false on rows past the canvas (block
  // mode), which are written as 0.
  __device__ __forceinline__ bool store(int wr, int wc, size_t& off,
                                        bool& live) const {
    const int br = r0 + wr, gc = c0 + wc;
    off = static_cast<size_t>(br) * n + gc;
    live = !kBlock || g0 + wr < n;
    return br < int_hi && gc < n;
  }
};

// Phases 2-4 of one canvas step without extrapolation (kernel B6's
// per-species solve; canvas_step.cu writes the same phases out for B4) on
// a window whose 3 planes X hold the state, unmasked: the right-hand side
// (+ the load, when kLoad and `load` is not null), the masked warm start,
// and the k Chebyshev iterations but the last x += d, each on a square one
// cell smaller than the last. R, Da and Db are 3-plane scratch. Returns
// the plane holding the last d, valid on the tile; X is valid there too.
// `s` is the Chebyshev scalar block (kChebScal).
template <int NT, bool kLoad, typename T, typename Win>
__device__ T* canvas_solve(const Geometry& g, const Win& w, const Rect& rc,
                           const T* __restrict__ C, const T* s, T* X, T* R,
                           T* Da, T* Db, const T* load) {
  const int W = w.W, PS = w.PS;
  const size_t nn = w.nn;
  const T inv_theta = s[0];
  T* Dc = Da;
  T* Dn = Db;

  // 2. Right-hand side and warm start (x0 goes to Dn). Crank-Nicolson
  //    reads S u, so its square shrinks by one.
  int lo = g.use_ka ? 1 : 0;
  for_square<NT>(W, lo, [&](int wr, int wc) {
    size_t off;
    const bool inside = w.cell(wr, wc, off);
    const int q = wr * W + wc;
    T m[3], y[3] = {T(0), T(0), T(0)};
    rect_masks(w.g0 + wr, w.c0 + wc, w.c, rc, m);
    if (g.use_ka) apply_canvas(C, nn, off, inside, X, q, W, PS, y);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const T u = X[f * PS + q];
      const T mass = inside ? __ldg(C + (15 + f) * nn + off) : T(0);
      T r;
      if (g.use_ka) {
        r = T(2) * mass * u + (T(1) - m[f]) * u - y[f];
      } else {
        r = mass * u;
      }
      if constexpr (kLoad) {
        if (load != nullptr && inside) r += load[f * nn + off];
      }
      R[f * PS + q] = r;
      Dn[f * PS + q] = m[f] * u;
    }
  });
  __syncthreads();

  // 3. x = x0, initial residual and search direction.
  ++lo;
  for_square<NT>(W, lo, [&](int wr, int wc) {
    size_t off;
    const bool inside = w.cell(wr, wc, off);
    const int q = wr * W + wc;
    T y[3];
    apply_canvas(C, nn, off, inside, Dn, q, W, PS, y);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int i = f * PS + q;
      const T idg = inside ? __ldg(C + (18 + f) * nn + off) : T(0);
      X[i] = Dn[i];
      const T r = R[i] - y[f];
      R[i] = r;
      Dc[i] = inv_theta * (idg * r);
    }
  });
  __syncthreads();

  // 4. The first k - 1 Chebyshev iterations: no reductions, one barrier
  //    each.
  for (int it = 0; it + 1 < g.n_iters; ++it) {
    const T a = s[1 + it];
    const T b = s[1 + g.n_iters + it];
    ++lo;
    for_square<NT>(W, lo, [&](int wr, int wc) {
      size_t off;
      const bool inside = w.cell(wr, wc, off);
      const int q = wr * W + wc;
      T y[3];
      apply_canvas(C, nn, off, inside, Dc, q, W, PS, y);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int i = f * PS + q;
        const T idg = inside ? __ldg(C + (18 + f) * nn + off) : T(0);
        const T d = Dc[i];
        X[i] += d;
        const T r = R[i] - y[f];
        R[i] = r;
        Dn[i] = a * d + b * (idg * r);
      }
    });
    __syncthreads();
    T* t = Dc;
    Dc = Dn;
    Dn = t;
  }
  return Dc;
}

}  // namespace crbe
