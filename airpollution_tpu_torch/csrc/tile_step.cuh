// One implicit CRBE time step on a T x T output tile of the (3, n, n)
// family canvases, computed entirely in shared memory.
//
// Shared by the whole-loop kernel (uniform_solver.cu, the counterpart of
// airpollution_tpu/ops/pallas_solver.py::_uniform_solver_kernel) and the
// one-step kernel (uniform_step.cu, the counterpart of
// airpollution_tpu/ops/pallas_hbm.py::_step_kernel).
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
// The last iteration's r and d are never read, so the step applies A
// k + 1 (Crank-Nicolson: k + 2) times, each reaching +-1 row and +-1
// column. A block loads a window of (T + 2h)^2 cells with h = k (+1 for
// Crank-Nicolson) and computes each phase on a square that shrinks by one
// cell per application of A: every value a phase reads was computed by the
// phase before, so nothing outside the window is needed, no read is
// bounds-checked, and no halo cell is computed that the tile cannot see.
// The last phase covers the tile exactly. Cells outside the canvas load as
// zero and every output is multiplied by the family rectangle, which keeps
// them zero. u_prev is read only pointwise, so it goes global -> register
// -> global and needs no shared-memory plane (staging it in the r plane to
// load it beside u measured ~10% slower on an H100).
//
// Shared memory: four planes (x, r, d, d_next) x 3 families x window cells.
// One thread computes all three families of a cell (the 15 terms share
// nine loads), visiting cells in row-major order with no integer division
// in the loop; the 22 operator scalars sit in registers. What bounds it on
// an H100 is shared-memory traffic, ~25 accesses per cell and phase (nine
// neighbour loads plus the pointwise x, r and d updates), times the halo's
// redundancy; device memory sees one read and one write of the state per
// step.

#pragma once

#include <cuda_runtime.h>

namespace crbe {

constexpr int kMaxIters = 64;
// Scalar block layout: 15 stencil coefficients, 3 interior mass constants,
// 3 inverse-diagonal constants, 1/theta, then a_0..a_{k-1}, b_0..b_{k-1}.
constexpr int kScalBase = 22;
constexpr int kMaxScal = kScalBase + 2 * kMaxIters;

struct Geometry {
  int n;              // canvas edge (mesh points per axis)
  int tile;           // output tile edge
  int halo;           // h = k + use_ka
  int tiles_per_row;  // ceil(n / tile)
  int n_iters;        // k
  int use_ka;         // Crank-Nicolson RHS
};

template <typename T>
struct StepIO {
  const T* u_in;   // (3, n, n)
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

inline size_t smem_bytes(int tile, int halo, size_t elem) {
  const size_t w = static_cast<size_t>(tile + 2 * halo);
  return 4 * 3 * w * w * elem;
}

// Copies the scalar block into shared memory (all threads of the block).
template <typename T>
__device__ void load_scalars(const T* scal_g, T* s, int n_iters) {
  for (int i = threadIdx.x; i < kScalBase + 2 * n_iters; i += blockDim.x) {
    s[i] = scal_g[i];
  }
  __syncthreads();
}

// Calls f(wr, wc) for every cell of the square [lo, W - lo)^2 of a W x W
// window, cells dealt to the NT threads in row-major order.
template <int NT, typename F>
__device__ __forceinline__ void for_square(int W, int lo, F&& f) {
  const int side = W - 2 * lo;
  if (side <= 0) return;
  const int dr = NT / side, dc = NT - dr * side;
  int wr = static_cast<int>(threadIdx.x) / side;
  int wc = static_cast<int>(threadIdx.x) - wr * side;
  for (int i = threadIdx.x; i < side * side; i += NT) {
    f(lo + wr, lo + wc);
    wr += dr;
    wc += dc;
    if (wc >= side) {
      wc -= side;
      ++wr;
    }
  }
}

// y = (unmasked) stencil rows of the three families at window index q of
// the family planes starting at P (plane stride PS, row stride W).
template <typename T>
__device__ __forceinline__ void apply3(const Coefs<T>& k, const T* P, int q,
                                       int W, int PS, T y[3]) {
  const T* H = P;
  const T* V = P + PS;
  const T* D = P + 2 * PS;
  const T h0 = H[q], hl = H[q - 1], hd = H[q + W];
  const T v0 = V[q], vr = V[q + 1], vu = V[q - W];
  const T d0 = D[q], dl = D[q - 1], du = D[q - W];
  y[0] = k.c[0] * h0 + k.c[1] * vr + k.c[2] * d0 + k.c[3] * vu +
         k.c[4] * du;
  y[1] = k.c[5] * v0 + k.c[6] * dl + k.c[7] * hl + k.c[8] * hd +
         k.c[9] * d0;
  y[2] = k.c[10] * d0 + k.c[11] * vr + k.c[12] * h0 + k.c[13] * hd +
         k.c[14] * v0;
}

// Interior rectangles at canvas cell (gr, gc): H rows [1, c) x cols [0, c),
// V rows [0, c) x cols [1, c), D [0, c)^2.
template <typename T>
__device__ __forceinline__ void rect_masks(int gr, int gc, int c, T m[3]) {
  const bool in_d = gr >= 0 && gr < c && gc >= 0 && gc < c;
  m[0] = (in_d && gr >= 1) ? T(1) : T(0);
  m[1] = (in_d && gc >= 1) ? T(1) : T(0);
  m[2] = in_d ? T(1) : T(0);
}

// One time step of output tile `tile_id`. State loads use __ldcg (L2 only):
// the whole-loop kernel rewrites the state between grid barriers, and L1 is
// not coherent across SMs. The load (a source load built by the caller,
// ops/loads.EmissionLoads) is a template parameter, so that the load-free
// step compiles exactly as it did before loads existed.
template <int NT, typename T, bool kLoad = false>
__device__ void tile_step(const Geometry& g, const T* s, const StepIO<T>& io,
                          int tile_id, T* smem) {
  const int n = g.n;
  const int c = n - 1;
  const int h = g.halo;
  const int W = g.tile + 2 * h;
  const int PS = W * W;
  const int r0 = (tile_id / g.tiles_per_row) * g.tile - h;
  const int c0 = (tile_id % g.tiles_per_row) * g.tile - h;
  const size_t nn = static_cast<size_t>(n) * n;
  T* X = smem;
  T* R = X + 3 * PS;
  T* Dc = R + 3 * PS;
  T* Dn = Dc + 3 * PS;
  const Coefs<T> k = load_coefs(s);

  // 1. Load the state window; cells outside the canvas are zero.
  for_square<NT>(W, 0, [&](int wr, int wc) {
    const int gr = r0 + wr, gc = c0 + wc;
    const bool inside = gr >= 0 && gr < n && gc >= 0 && gc < n;
    const size_t off = inside ? static_cast<size_t>(gr) * n + gc : 0;
    const int q = wr * W + wc;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      X[f * PS + q] = inside ? __ldcg(io.u_in + f * nn + off) : T(0);
    }
  });
  __syncthreads();

  // 2. Right-hand side and warm start (x0 goes to Dn). Crank-Nicolson
  //    reads A u, so its square shrinks by one.
  int lo = g.use_ka ? 1 : 0;
  for_square<NT>(W, lo, [&](int wr, int wc) {
    const int gr = r0 + wr, gc = c0 + wc;
    const int q = wr * W + wc;
    T m[3], y[3] = {T(0), T(0), T(0)};
    rect_masks(gr, gc, c, m);
    if (g.use_ka) apply3(k, X, q, W, PS, y);
    const bool inside = gr >= 0 && gr < n && gc >= 0 && gc < n;
    const bool own = wr >= h && wr < h + g.tile && wc >= h && wc < h + g.tile;
    const size_t off = inside ? static_cast<size_t>(gr) * n + gc : 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const T u = X[f * PS + q];
      T r = k.mass[f] * (m[f] * u);
      if (g.use_ka) r = T(2) * r - m[f] * y[f];
      if constexpr (kLoad) {
        if (inside) r += __ldg(io.load + f * nn + off);
      }
      R[f * PS + q] = r;
      T guess = u;
      if (io.up_in != nullptr) {
        const T up = inside ? __ldcg(io.up_in + f * nn + off) : T(0);
        guess = T(2) * u - up;
        if (own && inside) io.up_out[f * nn + off] = u;
      }
      Dn[f * PS + q] = m[f] * guess;
    }
  });
  __syncthreads();

  // 3. x = x0, initial residual and search direction.
  ++lo;
  for_square<NT>(W, lo, [&](int wr, int wc) {
    const int q = wr * W + wc;
    T m[3], y[3];
    rect_masks(r0 + wr, c0 + wc, c, m);
    apply3(k, Dn, q, W, PS, y);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int i = f * PS + q;
      X[i] = Dn[i];
      const T r = R[i] - m[f] * y[f];
      R[i] = r;
      Dc[i] = (k.idiag[f] * k.inv_theta) * r;
    }
  });
  __syncthreads();

  // 4. The first k - 1 Chebyshev iterations: no reductions, one barrier
  //    each.
  for (int it = 0; it + 1 < g.n_iters; ++it) {
    const T a = s[kScalBase + it];
    const T b = s[kScalBase + g.n_iters + it];
    ++lo;
    for_square<NT>(W, lo, [&](int wr, int wc) {
      const int q = wr * W + wc;
      T m[3], y[3];
      rect_masks(r0 + wr, c0 + wc, c, m);
      apply3(k, Dc, q, W, PS, y);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int i = f * PS + q;
        const T d = Dc[i];
        X[i] += d;
        const T r = R[i] - m[f] * y[f];
        R[i] = r;
        Dn[i] = a * d + (b * k.idiag[f]) * r;
      }
    });
    __syncthreads();
    T* t = Dc;
    Dc = Dn;
    Dn = t;
  }

  // 5. The last iteration's x += d on the tile itself, written back.
  for_square<NT>(W, h, [&](int wr, int wc) {
    const int gr = r0 + wr, gc = c0 + wc;
    if (gr >= n || gc >= n) return;
    const int q = wr * W + wc;
    const size_t off = static_cast<size_t>(gr) * n + gc;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      io.u_out[f * nn + off] = X[f * PS + q] + Dc[f * PS + q];
    }
  });
  __syncthreads();
}

}  // namespace crbe
