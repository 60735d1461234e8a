// The per-DOF canvas step shared by canvas_step.cu (one species, kernel
// B4, with its load, raw and block modes; the block mode is kernel B9) and
// multispecies_step.cu (K species with in-kernel chemistry, kernel B6; its
// block mode B10). The operator is a (21, n, n) stack (block mode: the
// block's (21, rows, n) rows):
//
//   C[0..14]   the 15 stencil coefficients of the MASKED system
//              (identity rows on Dirichlet and dead DOFs, zero outside each
//              family's rows), so a matvec needs no rectangle mask;
//   C[15..17]  the masked mass M (zero on Dirichlet and dead rows);
//   C[18..20]  the inverse system diagonal.
//
// Shape. A block computes one T x T output tile from a window of
// (T + 2h)^2 cells around it, in phases on squares that shrink by one cell
// per matvec (tile_step.cuh), so the last phase covers the tile exactly.
//
// Where the operator lives. Each thread owns a fixed set of window cells
// for every phase of the launch: cell j of thread t is window cell
// t + j NT in row-major order (NT threads, kCells cells each), so every
// shrinking square keeps all warps busy. A thread reads its cells' 15
// stencil coefficients and 3 inverse-diagonal values from device memory
// ONCE per launch into registers, and keeps its cells' x and r in
// registers too: neither is ever read by a neighbour. The mass planes are
// read in the right-hand-side phase only. Only the matvec operand d (and,
// for Crank-Nicolson's right-hand side, the state u) crosses threads,
// through shared memory, behind one barrier per phase: two d planes of 3
// families (d, d_next), 6 W^2 values per block (B6 adds its K mixed
// species states, 3 K W^2). Kernel B6's K species share one load of the
// coefficients.
//
// Temporal depth. Registers bound the window (W^2 <= NT kCells), so a deep
// step is split over `depth` launches ("spans") of about k / depth phases
// each: the halo of a span is its own phase count, not k. A span that is
// not the last writes x (on its tile), r and d (3 planes each, per species)
// to a work buffer in device memory, and the next span reads them on its
// window. Every cell does the same arithmetic in the same order as in one
// launch, so the output is unchanged (bitwise). Block mode: a span that is
// not the last covers the block's interior widened by the halos of the
// spans after it, which the block's halo rows always hold, so no exchange
// is needed between spans.
//
// What bounds it on an H100: device memory must see the coefficient stack
// once and the state once each way per step: (21 + 4 x 3) x n^2 x
// sizeof(T), 138.7 MB at 1025^2 in f32, 0.041 ms at 3.35 TB/s. Each launch
// reads each window's operator once, so the coefficient bytes that reach
// the SMs are the stack times the window's overlap, (T + 2h)^2 / T^2 per
// span: C1's step (1025^2, k=14, BE) runs as two spans of 30^2 tiles in
// 44^2 windows, 1,225 blocks each reading 1,936 cells x 18 values, 171 MB
// per span plus the mass planes once (28 MB), 370 MB in all, where the
// first design read 2.34 GB (the 18 values of every cell in every phase).
// One block fills an SM's registers, so a block's loads do not overlap
// another block's phases; after the loads come shared-memory operand
// traffic (9 loads and 3 stores per cell and phase), the halo's redundant
// phases, and one barrier per phase.

#pragma once

#include <cuda_runtime.h>

#include "tile_step.cuh"

// The compiled launch shape of B4 and B6 per dtype: threads per block and
// window cells per thread (each holds 24 values in registers). The
// defaults come from scripts/torch_port_b4_b6_ab.py --sweep on an H100,
// which builds other values with -D; ops/fused_hbm.CANVAS_SHAPE mirrors
// them.
#ifndef CANVAS_THREADS_F32
#define CANVAS_THREADS_F32 512
#endif
#ifndef CANVAS_CELLS_F32
#define CANVAS_CELLS_F32 4
#endif
#ifndef CANVAS_THREADS_F64
#define CANVAS_THREADS_F64 256
#endif
#ifndef CANVAS_CELLS_F64
#define CANVAS_CELLS_F64 4
#endif

namespace crbe {

// Chebyshev scalar block: 1/theta, a_0..a_{k-1}, b_0..b_{k-1}.
constexpr int kChebScal = 1 + 2 * kMaxIters;

template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int kThreads = CANVAS_THREADS_F32;
  static constexpr int kCells = CANVAS_CELLS_F32;
};
template <>
struct Shape<double> {
  static constexpr int kThreads = CANVAS_THREADS_F64;
  static constexpr int kCells = CANVAS_CELLS_F64;
};

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

  // Whether window cell (wr, wc) is written back: a covered cell of the
  // arrays; `off` its offset, `live` false on rows past the canvas (block
  // mode), which are written as 0.
  __device__ __forceinline__ bool store(int wr, int wc, size_t& off,
                                        bool& live) const {
    const int br = r0 + wr, gc = c0 + wc;
    off = static_cast<size_t>(br) * n + gc;
    live = !kBlock || g0 + wr < n;
    return br < int_hi && gc < n;
  }

  __device__ __forceinline__ bool on_tile(int wr, int wc) const {
    return wr >= h && wr < W - h && wc >= h && wc < W - h;
  }
};

// y = S x at one cell from its 15 coefficients, on the family planes
// starting at P (plane stride PS, row stride W), at window index q, whose
// own three values x0 the caller has read; the sums in the order of the
// masked system's rows (stencil.py).
template <typename T>
__device__ __forceinline__ void apply_cell(const T (&c)[15], const T* P,
                                           int q, int W, int PS,
                                           const T x0[3], T y[3]) {
  const T* H = P;
  const T* V = P + PS;
  const T* D = P + 2 * PS;
  const T h0 = x0[0], hl = H[q - 1], hd = H[q + W];
  const T v0 = x0[1], vr = V[q + 1], vu = V[q - W];
  const T d0 = x0[2], dl = D[q - 1], du = D[q - W];
  y[0] = c[0] * h0 + c[1] * vr + c[2] * d0 + c[3] * vu + c[4] * du;
  y[1] = c[5] * v0 + c[6] * dl + c[7] * hl + c[8] * hd + c[9] * d0;
  y[2] = c[10] * d0 + c[11] * vr + c[12] * h0 + c[13] * hd + c[14] * v0;
}

// The cells one thread owns for a whole launch, with their operator, x and
// r in registers (every index below is a compile-time constant once the
// cell loops unroll).
template <typename T, bool kBlock>
struct Cells {
  static constexpr int NT = Shape<T>::kThreads;
  static constexpr int P = Shape<T>::kCells;

  const Window<kBlock>& w;
  T c[P][15];
  T idg[P][3];
  T x[P][3];
  T r[P][3];
  unsigned inside = 0;  // bit j: cell j lies on the canvas of the arrays

  // Calls f(j, wr, wc) for each owned cell (wr, wc) of the square
  // [lo, W - lo)^2.
  template <typename F>
  __device__ __forceinline__ void each(int lo, F&& f) const {
    const int W = w.W;
    const int side = W - 2 * lo;
    if (side <= 0) return;
    const int dr = NT / W, dc = NT - (NT / W) * W;
    int wr = static_cast<int>(threadIdx.x) / W;
    int wc = static_cast<int>(threadIdx.x) - wr * W;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (static_cast<unsigned>(wr - lo) < static_cast<unsigned>(side) &&
          static_cast<unsigned>(wc - lo) < static_cast<unsigned>(side)) {
        f(j, wr, wc);
      }
      wr += dr;
      wc += dc;
      if (wc >= W) {
        wc -= W;
        ++wr;
      }
    }
  }

  __device__ __forceinline__ bool in(int j) const {
    return (inside >> j) & 1u;
  }

  // y = S P at cell j (0 off the canvas), and P's values there.
  __device__ __forceinline__ void matvec(int j, const T* Pl, int q, T y[3],
                                         T own[3]) const {
#pragma unroll
    for (int f = 0; f < 3; ++f) own[f] = Pl[f * w.PS + q];
    if (in(j)) {
      apply_cell(c[j], Pl, q, w.W, w.PS, own, y);
    } else {
      y[0] = y[1] = y[2] = T(0);
    }
  }

  // Reads the owned cells' coefficients and inverse diagonal once (0 off
  // the canvas).
  __device__ __forceinline__ Cells(const Window<kBlock>& win,
                                   const T* __restrict__ C)
      : w(win) {
    const size_t nn = w.nn;
    each(0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      inside |= static_cast<unsigned>(on) << j;
#pragma unroll
      for (int i = 0; i < 15; ++i) {
        c[j][i] = on ? __ldg(C + i * nn + off) : T(0);
      }
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        idg[j][f] = on ? __ldg(C + (18 + f) * nn + off) : T(0);
      }
    });
  }

  // The step's right-hand side (+ the load) and masked warm start on the
  // square lo = use_ka, the state u on the window planes U: r, and x = the
  // warm start, which also goes to the plane G for the next matvec. With
  // up_in, the warm start is extrapolated and u is written to up_out on the
  // tile's cells of the arrays' interior (block mode: the rows
  // [int_lo + ext, int_hi - ext), 0 past the canvas).
  template <bool kLoad>
  __device__ __forceinline__ void rhs(const Geometry& g, const Rect& rc,
                                      const T* __restrict__ C, const T* U,
                                      const T* load, const T* up_in,
                                      T* up_out, int ext, T* G) {
    const int W = w.W, PS = w.PS;
    const size_t nn = w.nn;
    each(g.use_ka ? 1 : 0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      const int q = wr * W + wc;
      T m[3], y[3] = {T(0), T(0), T(0)}, uq[3];
      rect_masks(w.g0 + wr, w.c0 + wc, w.c, rc, m);
      if (g.use_ka) {
        matvec(j, U, q, y, uq);
      } else {
#pragma unroll
        for (int f = 0; f < 3; ++f) uq[f] = U[f * PS + q];
      }
      const int br = w.r0 + wr, gc = w.c0 + wc;
      const bool own = w.on_tile(wr, wc);
      const bool keep =
          kBlock ? (own && br >= g.int_lo + ext && br < g.int_hi - ext &&
                    gc < w.n)
                 : (own && on);
      const size_t soff = kBlock ? static_cast<size_t>(br) * w.n + gc : off;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const T u = uq[f];
        const T mass = on ? __ldg(C + (15 + f) * nn + off) : T(0);
        T rv;
        if (g.use_ka) {
          rv = T(2) * mass * u + (T(1) - m[f]) * u - y[f];
        } else {
          rv = mass * u;
        }
        if constexpr (kLoad) {
          if (load != nullptr && on) rv += load[f * nn + off];
        }
        r[j][f] = rv;
        T guess = u;
        if (up_in != nullptr) {
          const T up = on ? up_in[f * nn + off] : T(0);
          guess = T(2) * u - up;
          if (keep) up_out[f * nn + soff] = u;
        }
        const T x0 = m[f] * guess;
        x[j][f] = x0;
        G[f * PS + q] = x0;
      }
    });
  }

  // The initial residual r -= S x0 and search direction d = (id r) / theta
  // on the square lo, x0 on the planes G; d goes to the planes D.
  __device__ __forceinline__ void initial(int lo, T inv_theta, const T* G,
                                          T* D) {
    const int W = w.W, PS = w.PS;
    each(lo, [&](int j, int wr, int wc) {
      const int q = wr * W + wc;
      T y[3], x0[3];
      matvec(j, G, q, y, x0);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const T rv = r[j][f] - y[f];
        r[j][f] = rv;
        D[f * PS + q] = inv_theta * (idg[j][f] * rv);
      }
    });
  }

  // Raw mode's start on the whole window: r = mask b, x = 0,
  // d = (id r) / theta to the planes D.
  __device__ __forceinline__ void raw_start(const Rect& rc, const T* b,
                                            T inv_theta, T* D) {
    const int W = w.W, PS = w.PS;
    const size_t nn = w.nn;
    each(0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      const int q = wr * W + wc;
      T m[3];
      rect_masks(w.g0 + wr, w.c0 + wc, w.c, rc, m);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const T bv = on ? b[f * nn + off] : T(0);
        const T rv = m[f] * bv;
        r[j][f] = rv;
        x[j][f] = T(0);
        D[f * PS + q] = inv_theta * (idg[j][f] * rv);
      }
    });
  }

  // A later span's start: r and d from the work planes on the window, x on
  // the tile (the only cells whose x is ever read), 0 off the canvas.
  __device__ __forceinline__ void resume(const T* work, T* D) {
    const int W = w.W, PS = w.PS;
    const size_t nn = w.nn;
    each(0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      const bool own = on && w.on_tile(wr, wc);
      const int q = wr * W + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        x[j][f] = own ? work[f * nn + off] : T(0);
        r[j][f] = on ? work[(3 + f) * nn + off] : T(0);
        D[f * PS + q] = on ? work[(6 + f) * nn + off] : T(0);
      }
    });
  }

  // Chebyshev iterations [it0, it1) from the square lo (no reductions, one
  // barrier each); d ping-pongs between Dc and Dn. Returns the planes of
  // the last d.
  __device__ __forceinline__ T* iterate(const T* s, int n_iters, int it0,
                                        int it1, int lo, T* Dc, T* Dn) {
    const int W = w.W, PS = w.PS;
    for (int it = it0; it < it1; ++it) {
      const T a = s[1 + it];
      const T b = s[1 + n_iters + it];
      ++lo;
      each(lo, [&](int j, int wr, int wc) {
        const int q = wr * W + wc;
        T y[3], d[3];
        matvec(j, Dc, q, y, d);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          x[j][f] += d[f];
          const T rv = r[j][f] - y[f];
          r[j][f] = rv;
          Dn[f * PS + q] = a * d[f] + b * (idg[j][f] * rv);
        }
      });
      __syncthreads();
      T* t = Dc;
      Dc = Dn;
      Dn = t;
    }
    return Dc;
  }

  // The last x += d on the tile, handed to out(j, wr, wc, f, value).
  template <typename F>
  __device__ __forceinline__ void finish(const T* D, F&& out) const {
    const int W = w.W, PS = w.PS;
    each(w.h, [&](int j, int wr, int wc) {
      const int q = wr * W + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) out(j, wr, wc, f, x[j][f] + D[f * PS + q]);
    });
  }

  // A span that is not the last: x, r and d of the tile's covered cells to
  // the work planes.
  __device__ __forceinline__ void suspend(const T* D, T* work) const {
    const int W = w.W, PS = w.PS;
    const size_t nn = w.nn;
    each(w.h, [&](int j, int wr, int wc) {
      size_t off;
      bool live;
      if (!w.store(wr, wc, off, live)) return;
      const int q = wr * W + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        work[f * nn + off] = x[j][f];
        work[(3 + f) * nn + off] = r[j][f];
        work[(6 + f) * nn + off] = D[f * PS + q];
      }
    });
  }
};

// The geometry of span j of a step on `g` (whole canvas or block): its
// halo, and in block mode the interior widened by the later spans' halos.
template <bool kBlock>
inline Geometry span_geometry(const Geometry& g, int halo, const Span& s) {
  if (!kBlock) return step_geometry(g.n, g.tile, halo, g.n_iters, g.use_ka);
  return block_geometry(g.n, g.rows, g.row0, g.int_lo - s.ext,
                        g.int_hi + s.ext, g.tile, halo, g.n_iters, g.use_ka);
}

// Whether a window of halo h fits the compiled launch shape.
template <typename T>
inline bool window_fits(int tile, int halo) {
  const long w = tile + 2 * halo;
  return w * w <= static_cast<long>(Shape<T>::kThreads) * Shape<T>::kCells;
}

}  // namespace crbe
