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
// Shape: tile_step.cuh's shrinking squares. A block loads a window of
// (T + 2h)^2 cells, h = k (+1 Crank-Nicolson), computes each phase on a
// square one cell smaller than the last, and writes the T x T tile back.
// Four state planes (x, r, d, d_next) x 3 families live in shared memory.
// The 21 coefficient planes do not fit beside them (a 44^2 window of 21
// planes is 163 KB in f32), so each cell reads the coefficients it
// multiplies from device memory through the read-only path (__ldg) in
// every phase; they never change during a solve and the L1 / L2 caches
// serve the repeats.
//
// What bounds it on an H100: device memory must see the coefficient stack
// once and the state once each way per step: (21 + 4 x 3) x n^2 x
// sizeof(T), 138.7 MB at 1025^2 in f32, 41 us at 3.35 TB/s (3 more planes
// with a load). The per-cell coefficient reads of every phase (x ~1.3 halo
// redundancy) make L1 / L2 traffic, not device memory, the likely limit of
// this simple design.

#include <cuda_runtime.h>

#include "canvas_tile.cuh"

namespace crbe {

// The phases are written out here rather than shared with B6 through
// canvas_tile.cuh's canvas_solve, and the load is a template parameter: a
// version that called canvas_solve and tested for the load at run time was
// ~5% slower on an H100 at 1025^2 (0.843 against 0.797 ms at k=14);
// written so, B4 without a load runs as it did before loads existed and a
// load adds ~4% (scripts/torch_port_b4_ab.py compares two trees' B4).
template <int NT, typename T, bool kLoad>
__global__ void __launch_bounds__(NT)
    canvas_step_kernel(Geometry g, Rect rc, const T* __restrict__ C,
                       const T* scal, const T* u_in, const T* up_in,
                       T* u_out, T* up_out, const int* halt,
                       const T* load) {
  if (halt != nullptr && *halt >= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s[kChebScal];
  for (int i = threadIdx.x; i < 1 + 2 * g.n_iters; i += NT) s[i] = scal[i];
  __syncthreads();

  const int n = g.n;
  const int c = n - 1;
  const int h = g.halo;
  const int W = g.tile + 2 * h;
  const int PS = W * W;
  const int tile_id = blockIdx.x;
  const int r0 = (tile_id / g.tiles_per_row) * g.tile - h;
  const int c0 = (tile_id % g.tiles_per_row) * g.tile - h;
  const size_t nn = static_cast<size_t>(n) * n;
  T* X = reinterpret_cast<T*>(smem_raw);
  T* R = X + 3 * PS;
  T* Dc = R + 3 * PS;
  T* Dn = Dc + 3 * PS;
  const T inv_theta = s[0];

  auto cell = [&](int wr, int wc, size_t& off) {
    const int gr = r0 + wr, gc = c0 + wc;
    const bool inside = gr >= 0 && gr < n && gc >= 0 && gc < n;
    off = inside ? static_cast<size_t>(gr) * n + gc : 0;
    return inside;
  };

  // 1. Load the state window; cells outside the canvas are zero.
  for_square<NT>(W, 0, [&](int wr, int wc) {
    size_t off;
    const bool inside = cell(wr, wc, off);
    const int q = wr * W + wc;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      X[f * PS + q] = inside ? u_in[f * nn + off] : T(0);
    }
  });
  __syncthreads();

  // 2. Right-hand side (+ the load) and warm start (x0 goes to Dn).
  //    Crank-Nicolson reads S u, so its square shrinks by one.
  int lo = g.use_ka ? 1 : 0;
  for_square<NT>(W, lo, [&](int wr, int wc) {
    size_t off;
    const bool inside = cell(wr, wc, off);
    const int q = wr * W + wc;
    T m[3], y[3] = {T(0), T(0), T(0)};
    rect_masks(r0 + wr, c0 + wc, c, rc, m);
    if (g.use_ka) apply_canvas(C, nn, off, inside, X, q, W, PS, y);
    const bool own = wr >= h && wr < h + g.tile && wc >= h && wc < h + g.tile;
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
        if (inside) r += load[f * nn + off];
      }
      R[f * PS + q] = r;
      T guess = u;
      if (up_in != nullptr) {
        const T up = inside ? up_in[f * nn + off] : T(0);
        guess = T(2) * u - up;
        if (own && inside) up_out[f * nn + off] = u;
      }
      Dn[f * PS + q] = m[f] * guess;
    }
  });
  __syncthreads();

  // 3. x = x0, initial residual and search direction.
  ++lo;
  for_square<NT>(W, lo, [&](int wr, int wc) {
    size_t off;
    const bool inside = cell(wr, wc, off);
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
      const bool inside = cell(wr, wc, off);
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

  // 5. The last iteration's x += d on the tile itself, written back.
  for_square<NT>(W, h, [&](int wr, int wc) {
    const int gr = r0 + wr, gc = c0 + wc;
    if (gr >= n || gc >= n) return;
    const int q = wr * W + wc;
    const size_t off = static_cast<size_t>(gr) * n + gc;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      u_out[f * nn + off] = X[f * PS + q] + Dc[f * PS + q];
    }
  });
}

template <int NT, typename T, bool kLoad>
int launch_canvas_step_as(const T* C, const T* scal, const T* u_in,
                          const T* up_in, T* u_out, T* up_out,
                          const int* halt, const T* load, Geometry g,
                          Rect rc, void* stream) {
  const size_t smem = smem_bytes(g.tile, g.halo, sizeof(T));
  static size_t smem_set = 0;
  cudaError_t err =
      ensure_smem(canvas_step_kernel<NT, T, kLoad>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  canvas_step_kernel<NT, T, kLoad>
      <<<g.tiles_per_row * g.tiles_per_row, NT, smem,
         static_cast<cudaStream_t>(stream)>>>(g, rc, C, scal, u_in, up_in,
                                              u_out, up_out, halt, load);
  return cudaGetLastError();
}

template <int NT, typename T>
int launch_canvas_step_nt(const T* C, const T* scal, const T* u_in,
                          const T* up_in, T* u_out, T* up_out,
                          const int* halt, const T* load, Geometry g,
                          Rect rc, void* stream) {
  if (load != nullptr) {
    return launch_canvas_step_as<NT, T, true>(C, scal, u_in, up_in, u_out,
                                              up_out, halt, load, g, rc,
                                              stream);
  }
  return launch_canvas_step_as<NT, T, false>(C, scal, u_in, up_in, u_out,
                                             up_out, halt, load, g, rc,
                                             stream);
}

template <typename T>
int launch_canvas_step(const T* C, const T* scal, const T* u_in,
                       const T* up_in, T* u_out, T* up_out, const int* halt,
                       const T* load, int n, int tile, int halo,
                       int n_iters, int use_ka,
                       int h_lo, int h_hi, int v_lo, int v_hi, int threads,
                       void* stream) {
  if (n_iters < 1 || n_iters > kMaxIters) return cudaErrorInvalidValue;
  if (halo < n_iters + (use_ka ? 1 : 0)) return cudaErrorInvalidValue;
  Geometry g;
  g.n = n;
  g.tile = tile;
  g.halo = halo;
  g.tiles_per_row = (n + tile - 1) / tile;
  g.n_iters = n_iters;
  g.use_ka = use_ka;
  Rect rc{h_lo, h_hi, v_lo, v_hi};
  if (threads == 256) {
    return launch_canvas_step_nt<256>(C, scal, u_in, up_in, u_out, up_out,
                                      halt, load, g, rc, stream);
  }
  if (threads == 512) {
    return launch_canvas_step_nt<512>(C, scal, u_in, up_in, u_out, up_out,
                                      halt, load, g, rc, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace crbe

extern "C" {

int crbe_canvas_step_f32(const float* C, const float* scal, const float* u_in,
                         const float* up_in, float* u_out, float* up_out,
                         const int* halt, const float* load, int n, int tile,
                         int halo, int n_iters, int use_ka, int h_lo,
                         int h_hi, int v_lo, int v_hi, int threads,
                         void* stream) {
  return crbe::launch_canvas_step<float>(C, scal, u_in, up_in, u_out, up_out,
                                         halt, load, n, tile, halo, n_iters,
                                         use_ka, h_lo, h_hi, v_lo, v_hi,
                                         threads, stream);
}

int crbe_canvas_step_f64(const double* C, const double* scal,
                         const double* u_in, const double* up_in,
                         double* u_out, double* up_out, const int* halt,
                         const double* load, int n, int tile, int halo,
                         int n_iters, int use_ka, int h_lo, int h_hi,
                         int v_lo, int v_hi, int threads, void* stream) {
  return crbe::launch_canvas_step<double>(C, scal, u_in, up_in, u_out,
                                          up_out, halt, load, n, tile, halo,
                                          n_iters, use_ka, h_lo, h_hi, v_lo,
                                          v_hi, threads, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
