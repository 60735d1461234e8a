// One implicit CRBE time step with the uniform operator on an output tile of
// the (3, n, n) family canvases: the device function of the whole-loop
// kernel (uniform_solver.cu, the counterpart of
// airpollution_tpu/ops/pallas_solver.py::_uniform_solver_kernel) and of the
// one-step kernel (uniform_step.cu, the counterpart of
// airpollution_tpu/ops/pallas_hbm.py::_step_kernel), whole canvas or one
// row block of it (kBlock, below). The geometry and span helpers at the top
// are shared with the canvas kernels (canvas_tile.cuh).
//
// The operator is the translation-invariant CR stencil in family layout:
// three canvases H, V, D of shape (n, n) (H holds an (n, c) grid, V (c, n),
// D (c, c), c = n - 1, zero elsewhere), 15 scalar coefficients, and a
// per-family interior rectangle outside which every matvec output is zero
// (Dirichlet rows and canvas padding). One step is
//
//   b  = M mask(u)                      (backward Euler)
//   b  = 2 M mask(u) - A u              (Crank-Nicolson, A the masked system)
//   b += load                           (optional source load, one plane)
//   x  = mask(2 u - u_prev) or mask(u)  (warm start)
//   r  = b - A x;  d = (id / theta) r
//   k times: x += d; r -= A d; d = a_k d + (b_k id) r   (Chebyshev, Saad 12.1)
//
// Shape. The last iteration's r and d are never read, so the step applies
// A k + 1 (Crank-Nicolson: k + 2) times, each reaching +-1 row and +-1
// column. A block computes a th x tw output tile from a window of
// (th + 2h) x (tw + 2h) cells, h = k (+1 for Crank-Nicolson), in phases on
// rectangles that shrink by one cell per application of A: every value a
// phase reads was computed by the phase before, so nothing outside the
// window is needed, no read is bounds-checked, and the last phase covers
// the tile exactly. Cells outside the canvas load as zero and every output
// is multiplied by the family rectangle, which keeps them zero.
//
// Ownership. Each thread owns fixed window cells for the whole launch: cell
// j of thread t is window cell t + j NT in row-major order (NT threads, P
// cells each, P the least compiled count that holds the window), so every
// shrinking rectangle keeps all warps busy. A thread keeps its cells' x and
// r (3 families each) and their rectangle masks in registers: neither is
// ever read by a neighbour. Only the matvec operand d crosses threads,
// through two shared planes (d, d_next) x 3 families; the warm start x0
// and, for Crank-Nicolson's A u, the state u pass through the same two
// planes. A phase then makes 12 shared-memory accesses per cell (nine
// loads, three stores) where a step held wholly in shared memory (x, r, d,
// d_next) made ~25, and the window, half the planes, can be twice as
// large, which cuts the halo's redundant phases. The 22 operator scalars
// sit in registers. Every cell's u and u_prev are loaded (into x and r)
// before any is used, and backward Euler needs no plane of u: its
// right-hand side is pointwise; the last phase writes x + d out instead of
// storing d: k (Crank-Nicolson k + 1) barriers per step.
//
// Tiles cover the live cells: global rows and columns below c, the rest of
// the canvas (its last row and column, the padding where every rectangle
// is zero) is written by the tiles beside it as 0 (u_prev: u). Tiles over
// all n rows and columns would add a row and a column of tiles one cell
// wide. ops/fused_solver.uniform_plan picks the tile (th, tw), balanced
// over the live cells, by one rule at every shape: the fewest waves of one
// block per SM on 132 SMs times the cell steps a thread takes over the
// step's phases.
//
// Temporal depth. Registers bound the window ((th + 2h)(tw + 2h) <= NT P),
// so a deep step is split over `depth` launches ("spans") of about
// k / depth phases each, as the canvas kernels split theirs: a span that is
// not the last writes x (on its tile), r and d to a work buffer of 9
// planes, and the next span reads them on its window (the padding as 0: the
// source load must be zero off the rectangles, as ops/loads builds it).
// Every cell does the same arithmetic in the same order at any tiling and
// depth, so the output does not depend on them (bitwise).
//
// Block mode (kBlock, the sharded-block kernel B8 of parallel/hbm_shard.py):
// the arrays hold an extended block of `rows` canvas rows by n columns whose
// row 0 is the global canvas row `row0` (negative for the first block), and
// the tiles cover the live rows of the interior rows [int_lo, int_hi) only
// (a span that is not the last widens them by the later spans' halos, which
// the block's halo rows hold). Every window then lies inside the block when
// the block's halo int_lo (and rows - int_hi) is at least the step's halo;
// cells past the block's rows load as zero and cannot reach a written row.
// The rectangle masks are evaluated at the global row row0 + r, a cell whose
// global row lies outside [0, n) (a chain-end halo row, or padding when the
// blocks overrun the canvas) acts as zero, and only the interior rows are
// written: 0 where the global row is past the canvas. The halo rows of the
// output stay as they were, to be refreshed by the caller's exchange before
// they are read. With kBlock false the geometry is the whole canvas (rows =
// n, row0 = 0, interior [0, n)). The plan picks a tile height that divides
// the block's live rows, so that the last tile row does not overrun them.
//
// What bounds it on an H100: device memory sees the state (and u_prev, and
// the load) once each way per step, 2 x 3 x n^2 x sizeof(T) per carried
// state; the k + 1 stencil applications over the shrinking window run from
// registers and shared memory and are the larger cost at k = 8.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// Threads per block of the uniform step kernels per dtype (compiled in;
// scripts/torch_port_ab.py --sweep builds other values with -D).
// ops/fused_solver.UNIFORM_SHAPE mirrors them and the cells per thread.
#ifndef UNIFORM_THREADS_F32
#define UNIFORM_THREADS_F32 512
#endif
#ifndef UNIFORM_THREADS_F64
#define UNIFORM_THREADS_F64 256
#endif

namespace crbe {

constexpr int kMaxIters = 64;
// Scalar block layout: 15 stencil coefficients, 3 interior mass constants,
// 3 inverse-diagonal constants, 1/theta, then a_0..a_{k-1}, b_0..b_{k-1}.
constexpr int kScalBase = 22;
constexpr int kMaxScal = kScalBase + 2 * kMaxIters;
// The most launches one step is split into (ops/fused_solver.MAX_DEPTH).
constexpr int kMaxDepth = 4;

// The canvas kernels' geometry (canvas_tile.cuh): square tiles over all n
// columns.
struct Geometry {
  int n;              // canvas edge (mesh points per axis)
  int tile;           // output tile edge
  int halo;           // h = k + use_ka
  int tiles_per_row;  // ceil(n / tile)
  int n_iters;        // k
  int use_ka;         // Crank-Nicolson RHS
  int tile_rows = 0;  // tiles along the rows of the grid
  // Block mode only: the block's rows, the global row of its row 0, and
  // its interior rows [int_lo, int_hi).
  int rows = 0;
  int row0 = 0;
  int int_lo = 0;
  int int_hi = 0;
};

// The whole canvas.
inline Geometry step_geometry(int n, int tile, int halo, int n_iters,
                              int use_ka) {
  Geometry g;
  g.n = n;
  g.tile = tile;
  g.halo = halo;
  g.tiles_per_row = (n + tile - 1) / tile;
  g.tile_rows = g.tiles_per_row;
  g.n_iters = n_iters;
  g.use_ka = use_ka;
  return g;
}

// The block of `rows` rows whose row 0 is global row row0, interior rows
// [int_lo, int_hi).
inline Geometry block_geometry(int n, int rows, int row0, int int_lo,
                               int int_hi, int tile, int halo, int n_iters,
                               int use_ka) {
  Geometry g = step_geometry(n, tile, halo, n_iters, use_ka);
  g.rows = rows;
  g.row0 = row0;
  g.int_lo = int_lo;
  g.int_hi = int_hi;
  g.tile_rows = (int_hi - int_lo + tile - 1) / tile;
  return g;
}

// A block-mode geometry is valid when the interior is inside the block and
// every window of an interior tile stays inside it: h <= int_lo and
// int_hi + h <= rows. (Rows the last tile reaches past int_hi + h are
// bounds-checked, and too far to reach a written row.)
inline bool block_fits(const Geometry& g) {
  return g.rows > 0 && g.int_lo >= g.halo && g.int_hi > g.int_lo &&
         g.int_hi + g.halo <= g.rows && g.row0 + g.int_lo >= 0;
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

// One launch of a step split over `depth` launches: the Chebyshev
// iterations [it0, it1) it runs, whether it starts the step (right-hand
// side and warm start, or raw mode's r = mask b) and ends it (the last
// x += d, written out), and `ext`, the halos of the spans after it (block
// mode widens the tiles' row range by it).
struct Span {
  int it0, it1;
  int first, last;
  int ext;
};

// The phases that shrink the square: the right-hand side (Crank-Nicolson
// only), the initial residual, and the k - 1 iterations with a matvec;
// raw mode: the k - 1 iterations alone.
inline int step_halo(int n_iters, int use_ka, bool raw) {
  return raw ? n_iters - 1 : n_iters + use_ka;
}

// Span j's halo: the H phases dealt as evenly as possible, the earlier
// spans taking the remainder (ops/fused_solver.step_spans).
inline int span_halo(int H, int depth, int j) {
  return H / depth + (j < H % depth ? 1 : 0);
}

// Whether `depth` spans are a valid split of the step: each later span runs
// at least one iteration and the first holds its leading phases.
inline bool depth_fits(int n_iters, int use_ka, bool raw, int depth) {
  const int H = step_halo(n_iters, use_ka, raw);
  if (depth < 1 || depth > kMaxDepth) return false;
  if (depth == 1) return true;
  const int lead = raw ? 1 : use_ka + 1;
  return depth <= H && span_halo(H, depth, 0) >= lead;
}

inline Span make_span(int n_iters, int use_ka, bool raw, int depth, int j,
                      int* halo) {
  const int H = step_halo(n_iters, use_ka, raw);
  const int lead = raw ? 0 : use_ka + 1;
  int before = 0, after = 0;
  for (int i = 0; i < depth; ++i) {
    if (i < j) before += span_halo(H, depth, i);
    if (i > j) after += span_halo(H, depth, i);
  }
  *halo = span_halo(H, depth, j);
  Span s;
  s.first = j == 0;
  s.last = j == depth - 1;
  s.it0 = j == 0 ? 0 : before - lead;
  s.it1 = before + *halo - lead;
  s.ext = after;
  return s;
}

// ---------------------------------------------------------------------------
// The uniform step.

template <typename T>
struct UniformShape;
template <>
struct UniformShape<float> {
  static constexpr int kThreads = UNIFORM_THREADS_F32;
  static constexpr int kMaxCells = 12;
};
template <>
struct UniformShape<double> {
  static constexpr int kThreads = UNIFORM_THREADS_F64;
  static constexpr int kMaxCells = 8;
};

// Calls f(std::integral_constant<int, P>) with the least compiled cells per
// thread P (4, 8, and 12 in float) that holds `cells`; an error when none
// does.
template <typename T, typename F>
inline int with_cells(long cells, F&& f) {
  if (cells <= 4) return f(std::integral_constant<int, 4>{});
  if (cells <= 8) return f(std::integral_constant<int, 8>{});
  if constexpr (UniformShape<T>::kMaxCells >= 12) {
    if (cells <= 12) return f(std::integral_constant<int, 12>{});
  }
  return cudaErrorInvalidValue;
}

// The window cells per thread a (th, tw) tile with halo h needs.
template <typename T>
inline long window_cells(int th, int tw, int halo) {
  const long w = static_cast<long>(th + 2 * halo) * (tw + 2 * halo);
  return (w + UniformShape<T>::kThreads - 1) / UniformShape<T>::kThreads;
}

inline size_t uniform_smem_bytes(int th, int tw, int halo, size_t elem) {
  return 6 * static_cast<size_t>(th + 2 * halo) * (tw + 2 * halo) * elem;
}

// The output tiles of one span: tile_rows x tiles_per_row tiles of th x tw
// cells over the live cells (rows [lo, live_hi) of the arrays, columns
// [0, c)). The tiles' written cells partition rows [lo, hi) x columns
// [0, n): the last tile row also writes rows [.., hi), the last tile column
// columns [.., n).
struct Tiling {
  int n;       // canvas edge
  int th, tw;  // tile rows and columns
  int halo;    // this span's halo
  int n_iters, use_ka;
  int rows;     // array rows (n for the whole canvas)
  int row0;     // global row of array row 0
  int lo, hi;   // written rows of the arrays
  int live_hi;  // computed rows [lo, live_hi): global rows below c
  int tiles_per_row, tile_rows;
};

inline Tiling uniform_tiling(int n, int rows, int row0, int lo, int hi,
                             int th, int tw, int halo, int n_iters,
                             int use_ka) {
  Tiling t;
  t.n = n;
  t.th = th;
  t.tw = tw;
  t.halo = halo;
  t.n_iters = n_iters;
  t.use_ka = use_ka;
  t.rows = rows;
  t.row0 = row0;
  t.lo = lo;
  t.hi = hi;
  const int c = n - 1;
  int live = c - row0;
  if (live > hi) live = hi;
  if (live < lo) live = lo;
  t.live_hi = live;
  const int tr = (live - lo + th - 1) / th;
  const int tc = (c + tw - 1) / tw;
  t.tile_rows = tr > 0 ? tr : 1;
  t.tiles_per_row = tc > 0 ? tc : 1;
  return t;
}

template <typename T>
struct StepIO {
  const T* u_in;   // (3, n, n); block mode (3, rows, n), as the others
  const T* up_in;  // nullptr without the extrapolated warm start
  T* u_out;
  T* up_out;
  const T* load;   // (3, n, n) load of this step; read only when kLoad
};

// The 22 operator scalars in registers.
template <typename T>
struct Coefs {
  T c[15];
  T mass[3];
  T idiag[3];
  T inv_theta;
};

template <typename T>
__device__ __forceinline__ Coefs<T> load_coefs(const T* s) {
  Coefs<T> k;
#pragma unroll
  for (int i = 0; i < 15; ++i) k.c[i] = s[i];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    k.mass[f] = s[15 + f];
    k.idiag[f] = s[18 + f];
  }
  k.inv_theta = s[21];
  return k;
}

// Copies the scalar block into shared memory (all threads of the block).
template <typename T>
__device__ void load_scalars(const T* scal_g, T* s, int n_iters) {
  for (int i = threadIdx.x; i < kScalBase + 2 * n_iters; i += blockDim.x) {
    s[i] = scal_g[i];
  }
  __syncthreads();
}

// y = (unmasked) stencil rows of the three families at window index q of
// the family planes starting at P (plane stride PS, row stride W), whose
// own three values o the caller holds.
template <typename T>
__device__ __forceinline__ void apply3(const Coefs<T>& k, const T* P, int q,
                                       int W, int PS, const T o[3], T y[3]) {
  const T* H = P;
  const T* V = P + PS;
  const T* D = P + 2 * PS;
  const T h0 = o[0], hl = H[q - 1], hd = H[q + W];
  const T v0 = o[1], vr = V[q + 1], vu = V[q - W];
  const T d0 = o[2], dl = D[q - 1], du = D[q - W];
  y[0] = k.c[0] * h0 + k.c[1] * vr + k.c[2] * d0 + k.c[3] * vu +
         k.c[4] * du;
  y[1] = k.c[5] * v0 + k.c[6] * dl + k.c[7] * hl + k.c[8] * hd +
         k.c[9] * d0;
  y[2] = k.c[10] * d0 + k.c[11] * vr + k.c[12] * h0 + k.c[13] * hd +
         k.c[14] * v0;
}

// Interior rectangles at canvas cell (gr, gc) as three bits: H rows [1, c)
// x cols [0, c), V rows [0, c) x cols [1, c), D [0, c)^2.
__device__ __forceinline__ unsigned rect_bits(int gr, int gc, int c) {
  const bool in_d = gr >= 0 && gr < c && gc >= 0 && gc < c;
  return (in_d && gr >= 1 ? 1u : 0u) | (in_d && gc >= 1 ? 2u : 0u) |
         (in_d ? 4u : 0u);
}

// The window of one output tile.
template <bool kBlock>
struct UWindow {
  int n, c, h, Wr, Wc, PS, rows;
  int r0, g0, c0;      // array row, global row and column of cell (0, 0)
  int rs, re, cs, ce;  // written cells: array rows [rs, re) x cols [cs, ce)
  size_t nn;

  __device__ UWindow(const Tiling& t, int id)
      : n(t.n), c(t.n - 1), h(t.halo), Wr(t.th + 2 * t.halo),
        Wc(t.tw + 2 * t.halo),
        PS((t.th + 2 * t.halo) * (t.tw + 2 * t.halo)),
        rows(kBlock ? t.rows : t.n), nn(static_cast<size_t>(rows) * t.n) {
    const int tr = id / t.tiles_per_row;
    const int tc = id - tr * t.tiles_per_row;
    rs = t.lo + tr * t.th;
    re = tr == t.tile_rows - 1 ? t.hi : rs + t.th;
    cs = tc * t.tw;
    ce = tc == t.tiles_per_row - 1 ? t.n : cs + t.tw;
    r0 = rs - h;
    g0 = (kBlock ? t.row0 : 0) + r0;
    c0 = cs - h;
  }

  // Whether window cell (wr, wc) holds a canvas cell of the arrays, and its
  // offset there.
  __device__ __forceinline__ bool cell(int wr, int wc, size_t& off) const {
    const int br = r0 + wr, gr = g0 + wr, gc = c0 + wc;
    const bool inside = (!kBlock || (br >= 0 && br < rows)) && gr >= 0 &&
                        gr < n && gc >= 0 && gc < n;
    off = inside ? static_cast<size_t>(br) * n + gc : 0;
    return inside;
  }

  // Whether window cell (wr, wc) is a live cell (global row and column
  // below c), the only cells a later span reads from the work planes.
  __device__ __forceinline__ bool live(int wr, int wc) const {
    return g0 + wr < c && c0 + wc < c;
  }

  // Whether window cell (wr, wc) is written back: a written cell of the
  // tile; `off` its offset, `alive` false on rows past the canvas (block
  // mode), which are written as 0.
  __device__ __forceinline__ bool store(int wr, int wc, size_t& off,
                                        bool& alive) const {
    const int br = r0 + wr, gc = c0 + wc;
    off = static_cast<size_t>(br) * n + gc;
    alive = !kBlock || g0 + wr < n;
    return br < re && gc < ce;
  }

  __device__ __forceinline__ bool on_tile(int wr, int wc) const {
    return wr >= h && wr < Wr - h && wc >= h && wc < Wc - h;
  }
};

// The cells one thread owns for a whole launch, with their x, r and
// rectangle masks in registers (every index below is a compile-time
// constant once the cell loops unroll).
template <int NT, int P, typename T, bool kBlock>
struct UCells {
  const UWindow<kBlock>& w;
  T x[P][3];
  T r[P][3];
  unsigned long long mb = 0;  // bits 3j..3j+2: cell j's rectangle masks

  // Calls f(j, wr, wc) for each owned cell (wr, wc) of the rectangle
  // [lo, Wr - lo) x [lo, Wc - lo).
  template <typename F>
  __device__ __forceinline__ void each(int lo, F&& f) const {
    const int Wc = w.Wc;
    const int side_r = w.Wr - 2 * lo, side_c = Wc - 2 * lo;
    if (side_r <= 0 || side_c <= 0) return;
    const int dr = NT / Wc, dc = NT - (NT / Wc) * Wc;
    int wr = static_cast<int>(threadIdx.x) / Wc;
    int wc = static_cast<int>(threadIdx.x) - wr * Wc;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (static_cast<unsigned>(wr - lo) < static_cast<unsigned>(side_r) &&
          static_cast<unsigned>(wc - lo) < static_cast<unsigned>(side_c)) {
        f(j, wr, wc);
      }
      wr += dr;
      wc += dc;
      if (wc >= Wc) {
        wc -= Wc;
        ++wr;
      }
    }
  }

  __device__ __forceinline__ T mask(int j, int f) const {
    return ((mb >> (3 * j + f)) & 1ull) ? T(1) : T(0);
  }

  __device__ __forceinline__ explicit UCells(const UWindow<kBlock>& win)
      : w(win) {
    each(0, [&](int j, int wr, int wc) {
      mb |= static_cast<unsigned long long>(
                rect_bits(w.g0 + wr, w.c0 + wc, w.c))
            << (3 * j);
    });
  }

  // The state u and u_prev of every owned cell into x and r (zero off the
  // canvas, u_prev zero without it), which hold them until the right-hand
  // side turns them into x0 and r: every cell's loads issue before any is
  // used. Crank-Nicolson also puts u on the planes U for its A u.
  __device__ __forceinline__ void load_state(const StepIO<T>& io, bool cn,
                                             T* U) {
    each(0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      const bool prev = on && io.up_in != nullptr;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        x[j][f] = on ? __ldcg(io.u_in + f * w.nn + off) : T(0);
        r[j][f] = prev ? __ldcg(io.up_in + f * w.nn + off) : T(0);
      }
    });
    if (!cn) return;
    each(0, [&](int j, int wr, int wc) {
      const int q = wr * w.Wc + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) U[f * w.PS + q] = x[j][f];
    });
  }

  // The right-hand side (+ the load) and masked warm start on the rectangle
  // lo = use_ka, from u in x and u_prev in r (load_state): r, and x = the
  // warm start, which also goes to the planes G for the next matvec;
  // Crank-Nicolson's A u reads u on the planes U. With up_in, the warm
  // start is extrapolated and u is written to up_out on the tile's written
  // cells of the rows [t.lo + ext, t.hi - ext) (0 past the canvas, where u
  // loads as 0).
  template <bool kLoad>
  __device__ __forceinline__ void rhs(const Coefs<T>& k, const Tiling& t,
                                      const StepIO<T>& io, int ext,
                                      const T* U, T* G) {
    each(t.use_ka ? 1 : 0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off);
      const int q = wr * w.Wc + wc;
      T y[3] = {T(0), T(0), T(0)};
      if (t.use_ka) apply3(k, U, q, w.Wc, w.PS, x[j], y);
      const int br = w.r0 + wr, gc = w.c0 + wc;
      const bool keep = w.on_tile(wr, wc) && br >= t.lo + ext &&
                        br < t.hi - ext && br < w.re && gc < w.ce;
      const size_t soff = static_cast<size_t>(br) * w.n + gc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const T u = x[j][f];
        const T m = mask(j, f);
        T rv = k.mass[f] * (m * u);
        if (t.use_ka) rv = T(2) * rv - m * y[f];
        if constexpr (kLoad) {
          if (on) rv += __ldg(io.load + f * w.nn + off);
        }
        T guess = u;
        if (io.up_in != nullptr) {
          guess = T(2) * u - r[j][f];
          if (keep) io.up_out[f * w.nn + soff] = u;
        }
        r[j][f] = rv;
        const T x0 = m * guess;
        x[j][f] = x0;
        G[f * w.PS + q] = x0;
      }
    });
  }

  // The initial residual r -= mask (A x0) and search direction
  // d = (id / theta) r on the rectangle lo, x0 on the planes G; d goes to
  // the planes D, or (kOut: the step's last phase) x0 + d to out.
  template <bool kOut, typename F>
  __device__ __forceinline__ void initial(int lo, const Coefs<T>& k,
                                          const T* G, T* D, F&& out) {
    each(lo, [&](int j, int wr, int wc) {
      const int q = wr * w.Wc + wc;
      T y[3];
      apply3(k, G, q, w.Wc, w.PS, x[j], y);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const T rv = r[j][f] - mask(j, f) * y[f];
        r[j][f] = rv;
        const T d = (k.idiag[f] * k.inv_theta) * rv;
        if constexpr (kOut) {
          out(wr, wc, f, x[j][f] + d);
        } else {
          D[f * w.PS + q] = d;
        }
      }
    });
  }

  // One Chebyshev iteration on the rectangle lo: x += d; r -= mask (A d);
  // d' = a d + (b id) r, with d on the planes Dc; d' goes to Dn, or (kOut:
  // the step's last phase) x + d' to out.
  template <bool kOut, typename F>
  __device__ __forceinline__ void iteration(int lo, const Coefs<T>& k, T a,
                                            T b, const T* Dc, T* Dn,
                                            F&& out) {
    each(lo, [&](int j, int wr, int wc) {
      const int q = wr * w.Wc + wc;
      T d[3], y[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) d[f] = Dc[f * w.PS + q];
      apply3(k, Dc, q, w.Wc, w.PS, d, y);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        x[j][f] += d[f];
        const T rv = r[j][f] - mask(j, f) * y[f];
        r[j][f] = rv;
        const T dn = a * d[f] + (b * k.idiag[f]) * rv;
        if constexpr (kOut) {
          out(wr, wc, f, x[j][f] + dn);
        } else {
          Dn[f * w.PS + q] = dn;
        }
      }
    });
  }

  // A later span's start: r and d from the work planes on the window, x on
  // the tile (the only cells whose x is ever read); 0 off the live cells.
  __device__ __forceinline__ void resume(const T* work, T* D) {
    each(0, [&](int j, int wr, int wc) {
      size_t off;
      const bool on = w.cell(wr, wc, off) && w.live(wr, wc);
      const bool own = on && w.on_tile(wr, wc);
      const int q = wr * w.Wc + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        x[j][f] = own ? work[f * w.nn + off] : T(0);
        r[j][f] = on ? work[(3 + f) * w.nn + off] : T(0);
        D[f * w.PS + q] = on ? work[(6 + f) * w.nn + off] : T(0);
      }
    });
  }

  // A span that is not the last: x, r and d (on the planes D) of the tile's
  // written cells to the work planes.
  __device__ __forceinline__ void suspend(const T* D, T* work) const {
    each(w.h, [&](int j, int wr, int wc) {
      size_t off;
      bool alive;
      if (!w.store(wr, wc, off, alive)) return;
      const int q = wr * w.Wc + wc;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        work[f * w.nn + off] = x[j][f];
        work[(3 + f) * w.nn + off] = r[j][f];
        work[(6 + f) * w.nn + off] = D[f * w.PS + q];
      }
    });
  }
};

// The tile's written cells outside its computed tile (the canvas's last
// row and column, and in block mode the rows past the live rows): u_out 0
// in the last span, u_prev out = u in the first (0 past the canvas).
template <typename T, bool kBlock>
__device__ void uniform_edges(const UWindow<kBlock>& w, const Tiling& t,
                              const Span& sp, const StepIO<T>& io) {
  const int ext = kBlock ? sp.ext : 0;  // the rows the tiling was widened by
  const int er = w.re - w.rs, ec = w.ce - w.cs;
  if (er <= t.th && ec <= t.tw) return;
  const bool up = sp.first && io.up_in != nullptr;
  if (!sp.last && !up) return;
  for (int i = threadIdx.x; i < er * ec; i += blockDim.x) {
    const int dr = i / ec, dc = i - dr * ec;
    if (dr < t.th && dc < t.tw) continue;  // a computed cell
    const int br = w.rs + dr;
    const size_t off = static_cast<size_t>(br) * w.n + (w.cs + dc);
    const bool on = !kBlock || w.g0 + w.h + dr < w.n;
    const bool keep = up && br >= t.lo + ext && br < t.hi - ext;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if (sp.last) io.u_out[f * w.nn + off] = T(0);
      if (keep) {
        io.up_out[f * w.nn + off] = on ? __ldcg(io.u_in + f * w.nn + off)
                                       : T(0);
      }
    }
  }
}

// One span of one time step on output tile `tile_id` (NT threads, P cells
// each; smem: 6 window planes). State loads use __ldcg (L2 only): the
// whole-loop kernel rewrites the state between grid barriers, and L1 is not
// coherent across SMs. The load and the block mode are template
// parameters, so that the load-free whole-canvas step compiles without
// either. A caller that runs several tiles in one block separates them by
// a barrier (the planes are reused).
template <int NT, int P, typename T, bool kLoad, bool kBlock>
__device__ void uniform_span(const Tiling& t, const Span& sp, const T* s,
                             const Coefs<T>& k, const StepIO<T>& io,
                             const T* work_in, T* work_out, int tile_id,
                             T* smem) {
  const UWindow<kBlock> w(t, tile_id);
  UCells<NT, P, T, kBlock> cells(w);
  T* Dc = smem;
  T* Dn = smem + 3 * w.PS;
  auto out = [&](int wr, int wc, int f, T v) {
    size_t off;
    bool alive;
    if (w.store(wr, wc, off, alive)) {
      io.u_out[f * w.nn + off] = alive ? v : T(0);
    }
  };
  int lo = 0;
  bool done = false;
  if (!sp.first) {
    cells.resume(work_in, Dc);
    __syncthreads();
  } else {
    // The state window in Dc (Crank-Nicolson), the warm start to Dn, the
    // first d back to Dc.
    cells.load_state(io, t.use_ka, Dc);
    if (t.use_ka) __syncthreads();
    cells.template rhs<kLoad>(k, t, io, kBlock ? sp.ext : 0, Dc, Dn);
    __syncthreads();
    lo = t.use_ka ? 2 : 1;
    if (sp.last && sp.it1 == sp.it0) {
      cells.template initial<true>(lo, k, Dn, Dc, out);
      done = true;
    } else {
      cells.template initial<false>(lo, k, Dn, Dc, out);
      __syncthreads();
    }
  }
  for (int it = sp.it0; it < sp.it1 && !done; ++it) {
    const T a = s[kScalBase + it];
    const T b = s[kScalBase + t.n_iters + it];
    ++lo;
    if (sp.last && it + 1 == sp.it1) {
      cells.template iteration<true>(lo, k, a, b, Dc, Dn, out);
      done = true;
    } else {
      cells.template iteration<false>(lo, k, a, b, Dc, Dn, out);
      __syncthreads();
      T* tmp = Dc;
      Dc = Dn;
      Dn = tmp;
    }
  }
  if (!sp.last) cells.suspend(Dc, work_out);
  uniform_edges<T, kBlock>(w, t, sp, io);
}

// The tiling of span j of a step over written rows [lo, hi) of the arrays:
// the whole canvas, or in block mode the interior, widened by the later
// spans' halos (which the block's halo rows hold).
inline Tiling span_tiling(bool block, int n, int rows, int row0, int lo,
                          int hi, int th, int tw, int n_iters, int use_ka,
                          int depth, int j, Span* sp) {
  int halo;
  *sp = make_span(n_iters, use_ka, false, depth, j, &halo);
  const int ext = block ? sp->ext : 0;
  return uniform_tiling(n, rows, row0, lo - ext, hi + ext, th, tw, halo,
                        n_iters, use_ka);
}

// Whether a step is launchable: k and depth valid and, in block mode (a
// block of `rows` rows with interior [int_lo, int_hi)), every span's
// window inside the block.
inline bool uniform_fits(bool block, int n, int rows, int row0, int int_lo,
                         int int_hi, int th, int tw, int n_iters, int use_ka,
                         int depth) {
  if (n < 2 || th < 1 || tw < 1) return false;
  if (n_iters < 1 || n_iters > kMaxIters) return false;
  if (!depth_fits(n_iters, use_ka, false, depth)) return false;
  if (!block) return true;
  const int H = step_halo(n_iters, use_ka, false);
  return int_hi > int_lo && int_lo >= H && int_hi + H <= rows &&
         row0 + int_lo >= 0;
}

}  // namespace crbe
