// Whole-loop fused CRBE solve with fixed-k BiCGStab, templated on the
// operator: every time step of the solve in ONE cooperative launch.
//
// Shared by kernel B5 (canvas_solver.cu: the per-DOF canvas operator, the
// counterpart of airpollution_tpu/ops/pallas_solver.py::_solver_kernel) and
// B1's BiCGStab variant (uniform_bicgstab.cu: the 15-scalar uniform
// operator, the counterpart of _uniform_solver_kernel with
// method="bicgstab"). The TPU kernels keep every canvas in one core's VMEM
// and loop over steps and iterations inside the kernel. On Hopper no block
// holds the state, so this is a cooperative persistent kernel: the grid is
// no larger than the number of co-resident blocks, every thread owns the
// same canvas cells (all three families of each) for the whole solve, and a
// grid barrier (cg::grid_group::sync, which fences memory) separates each
// phase that reads what other blocks wrote. Each matvec needs its
// neighbours' fresh values, so the shrinking-square tiles of tile_step.cuh
// do not apply. The state and the six Krylov canvases (about 5 MB at 257^2
// in f32, plus B5's 24 operator canvases) stay in the 50 MB L2; values
// other blocks wrote are loaded with __ldcg (L1 is not coherent across SMs).
//
// One step (the JAX kernels' arithmetic, Jacobi right preconditioning,
// _EPS = 1e-30 substituted for a zero denominator where the JAX kernels
// do). `Op` supplies the system matvec S (apply), the RHS and the masks,
// and load(), called once per thread at the start:
//
//   [CN]  t = S u; r = op.cn_rhs(u, t)                             | sync
//         r = op.be_rhs(u) (BE); r += load (when given);
//         u = mask (2 u - u_prev), u_prev = u (or u = mask u)      | sync
//         t = S u; r -= t; rhat = r; p = v = 0; partial (rhat, r)  | sync
//   k times, (rho, alpha, omega) reset to 1 each step:
//         rho = sum; beta; p = r + beta (p - omega v); w = id p   | sync
//         v = S w; partial (rhat, v)                               | sync
//         alpha; u += alpha w; r -= alpha v; w = id r              | sync
//         t = S w; partials (t, t), (t, r)                         | sync
//         omega; u += omega w; r -= omega t; partial (rhat, r)     | sync
//
// Grid barriers: 5 per iteration plus 2 per step (3 with Crank-Nicolson):
// 27 per step at k = 5 in backward Euler, 28 in Crank-Nicolson. They set
// the kernel's time at the sizes this path serves: the arithmetic of a
// phase is a few hundred thousand cells spread over the whole card.
//
// The dot products must come out bit-identical in every block, or the
// blocks take different steps and the tiles drift apart. Each thread sums
// its own cells in a fixed order, each block reduces its threads in a fixed
// tree and writes one partial to a global buffer; after the barrier every
// block adds all partials in the same fixed order. No atomics: their order
// changes from run to run. The sums and the scalar recurrence (rho, alpha,
// omega, beta) are carried in double for float data too, as in the plain
// versions (ops/fused_solver._bicgstab_iterations), so that a kernel and
// its plain version differ only by the rounding of the vector updates, not
// by the order of their sums. (A fixed-k BiCGStab iterate keeps iterating
// at rounding level, and in float some configurations amplify any rounding
// difference: chip_smoke.py's BiCGStab phases measure and print it.)

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace crbe {

namespace cg = cooperative_groups;

constexpr int kMaxGrid = 2048;  // partial-sum slots per reduction

template <typename T>
struct SolverIO {
  T* u;   // (3, n, n) state, u0 on entry
  T* up;  // (3, n, n) previous state, u_prev on entry, or nullptr
  T* r;
  T* rh;
  T* p;
  T* v;
  T* t;
  T* w;
  const T* load;       // step i's load at load + i * load_stride, or nullptr
  size_t load_stride;  // 0: one plane for every step
  double* part;        // (4, kMaxGrid): rho, (rhat, v), (t, t), (t, r)
};

__device__ __forceinline__ double guard(double a) {
  return a == 0.0 ? 1e-30 : a;
}

// Fixed-order block sum of one value per thread (result in every thread).
template <int NT>
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NT / 32 ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Sum of the G partials of one reduction, in one fixed order, identical in
// every block.
__device__ __forceinline__ double grid_total(const double* part, int G,
                                             double* red) {
  double v = 0.0;
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < G; i += 32) v += __ldcg(part + i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  if (threadIdx.x == 0) red[33] = v;
  __syncthreads();
  return red[33];
}

// The nine neighbour values a stencil row of cell (i, j) reads, through
// L2; cells outside the canvas are zero.
template <typename T>
struct Neighbours {
  T h0, hl, hd, v0, vr, vu, d0, dl, du;
};

template <typename T>
__device__ __forceinline__ Neighbours<T> neighbours(const T* x, int n, int i,
                                                   int j) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t q = static_cast<size_t>(i) * n + j;
  const T* H = x;
  const T* V = x + nn;
  const T* D = x + 2 * nn;
  const bool up = i >= 1, down = i + 1 < n, left = j >= 1, right = j + 1 < n;
  Neighbours<T> a;
  a.h0 = __ldcg(H + q);
  a.hl = left ? __ldcg(H + q - 1) : T(0);
  a.hd = down ? __ldcg(H + q + n) : T(0);
  a.v0 = __ldcg(V + q);
  a.vr = right ? __ldcg(V + q + 1) : T(0);
  a.vu = up ? __ldcg(V + q - n) : T(0);
  a.d0 = __ldcg(D + q);
  a.dl = left ? __ldcg(D + q - 1) : T(0);
  a.du = up ? __ldcg(D + q - n) : T(0);
  return a;
}

template <int NT, typename T, class Op>
__global__ void __launch_bounds__(NT)
    bicgstab_kernel(Op op_arg, SolverIO<T> io, int n, int n_steps,
                    int n_iters, int use_ka) {
  __shared__ double red[34];
  Op op = op_arg;
  op.load();  // an operator held in registers reads its values once
  cg::grid_group grid = cg::this_grid();
  const size_t nn = static_cast<size_t>(n) * n;
  const int G = gridDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  const size_t stride = static_cast<size_t>(G) * NT;
  double* part_rho = io.part;
  double* part_den = io.part + kMaxGrid;
  double* part_tt = io.part + 2 * kMaxGrid;
  double* part_tr = io.part + 3 * kMaxGrid;

  // Calls f(q, i, j) for each canvas cell this thread owns.
  auto for_cells = [&](auto&& f) {
    for (size_t q = first; q < nn; q += stride) {
      const int i = static_cast<int>(q / n);
      f(q, i, static_cast<int>(q - static_cast<size_t>(i) * n));
    }
  };
  auto ld = [](const T* p) { return __ldcg(p); };

  for (int step = 0; step < n_steps; ++step) {
    if (use_ka) {
      for_cells([&](size_t q, int i, int j) {
        T y[3];
        op.apply(io.u, i, j, q, y);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          io.r[o] = op.cn_rhs(f, ld(io.u + o), y[f], i, j, q);
        }
      });
      grid.sync();
    }
    const T* load =
        io.load == nullptr ? nullptr : io.load + step * io.load_stride;
    for_cells([&](size_t q, int i, int j) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const size_t o = f * nn + q;
        const T u = ld(io.u + o);
        const T mk = op.mask(f, i, j, q);
        T r = use_ka ? ld(io.r + o) : op.be_rhs(f, u, i, j, q);
        if (load != nullptr) r += __ldg(load + o);
        io.r[o] = r;
        if (io.up != nullptr) {
          const T guess = T(2) * u - ld(io.up + o);
          io.up[o] = u;
          io.u[o] = guess * mk;
        } else {
          io.u[o] = u * mk;
        }
      }
    });
    grid.sync();
    double acc = 0.0;
    for_cells([&](size_t q, int i, int j) {
      T y[3];
      op.apply(io.u, i, j, q, y);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const size_t o = f * nn + q;
        const T r = ld(io.r + o) - y[f];
        io.r[o] = r;
        io.rh[o] = r;
        io.p[o] = T(0);
        io.v[o] = T(0);
        acc += static_cast<double>(r * r);
      }
    });
    double s = block_sum<NT>(acc, red);
    if (threadIdx.x == 0) part_rho[blockIdx.x] = s;
    grid.sync();

    double rho_old = 1.0, alpha = 1.0, omega = 1.0;
    for (int it = 0; it < n_iters; ++it) {
      const double rho = grid_total(part_rho, G, red);
      const T beta = static_cast<T>((rho / guard(rho_old)) *
                                    (alpha / guard(omega)));
      const T omega_t = static_cast<T>(omega);
      for_cells([&](size_t q, int, int) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          const T p = ld(io.r + o) +
                      beta * (ld(io.p + o) - omega_t * ld(io.v + o));
          io.p[o] = p;
          io.w[o] = op.idiag(f, q) * p;
        }
      });
      grid.sync();

      acc = 0.0;
      for_cells([&](size_t q, int i, int j) {
        T y[3];
        op.apply(io.w, i, j, q, y);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          io.v[o] = y[f];
          acc += static_cast<double>(ld(io.rh + o) * y[f]);
        }
      });
      s = block_sum<NT>(acc, red);
      if (threadIdx.x == 0) part_den[blockIdx.x] = s;
      grid.sync();

      alpha = rho / guard(grid_total(part_den, G, red));
      const T alpha_t = static_cast<T>(alpha);
      for_cells([&](size_t q, int, int) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          io.u[o] = ld(io.u + o) + alpha_t * ld(io.w + o);
          const T r = ld(io.r + o) - alpha_t * ld(io.v + o);
          io.r[o] = r;
          io.w[o] = op.idiag(f, q) * r;
        }
      });
      grid.sync();

      double acc_tt = 0.0, acc_tr = 0.0;
      for_cells([&](size_t q, int i, int j) {
        T y[3];
        op.apply(io.w, i, j, q, y);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          io.t[o] = y[f];
          acc_tt += static_cast<double>(y[f] * y[f]);
          acc_tr += static_cast<double>(y[f] * ld(io.r + o));
        }
      });
      s = block_sum<NT>(acc_tt, red);
      if (threadIdx.x == 0) part_tt[blockIdx.x] = s;
      s = block_sum<NT>(acc_tr, red);
      if (threadIdx.x == 0) part_tr[blockIdx.x] = s;
      grid.sync();

      omega = grid_total(part_tr, G, red) / guard(grid_total(part_tt, G, red));
      const T omega_new = static_cast<T>(omega);
      acc = 0.0;
      for_cells([&](size_t q, int, int) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          io.u[o] = ld(io.u + o) + omega_new * ld(io.w + o);
          const T r = ld(io.r + o) - omega_new * ld(io.t + o);
          io.r[o] = r;
          acc += static_cast<double>(ld(io.rh + o) * r);
        }
      });
      s = block_sum<NT>(acc, red);
      if (threadIdx.x == 0) part_rho[blockIdx.x] = s;
      grid.sync();
      rho_old = rho;
    }
  }
}

template <int NT, typename T, class Op>
int launch_bicgstab_nt(const Op& op, SolverIO<T> io, int n, int n_steps,
                       int n_iters, int use_ka, void* stream, int* grid_out) {
  auto kernel = bicgstab_kernel<NT, T, Op>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long cells = static_cast<long>(n) * n;
  long grid = static_cast<long>(per_sm) * sms;
  if (grid > (cells + NT - 1) / NT) grid = (cells + NT - 1) / NT;
  if (grid > kMaxGrid) grid = kMaxGrid;
  *grid_out = static_cast<int>(grid);
  Op op_arg = op;
  void* args[] = {&op_arg, &io, &n, &n_steps, &n_iters, &use_ka};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(NT),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The solve's buffers: `work` holds the six Krylov canvases (r, rhat, p, v,
// t, w) of 3 n^2 values each.
template <typename T, class Op>
int launch_bicgstab(const Op& op, T* u, T* up, T* work, double* partials,
                    const T* load, int load_stride, int n, int n_steps,
                    int n_iters, int use_ka, int threads, void* stream,
                    int* grid_out) {
  if (n < 2 || n_iters < 1 || load_stride < 0) return cudaErrorInvalidValue;
  const size_t plane = 3 * static_cast<size_t>(n) * n;
  SolverIO<T> io;
  io.u = u;
  io.up = up;
  io.r = work;
  io.rh = work + plane;
  io.p = work + 2 * plane;
  io.v = work + 3 * plane;
  io.t = work + 4 * plane;
  io.w = work + 5 * plane;
  io.load = load;
  io.load_stride = static_cast<size_t>(load_stride);
  io.part = partials;
  if (threads == 256) {
    return launch_bicgstab_nt<256>(op, io, n, n_steps, n_iters, use_ka,
                                   stream, grid_out);
  }
  if (threads == 512) {
    return launch_bicgstab_nt<512>(op, io, n, n_steps, n_iters, use_ka,
                                   stream, grid_out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace crbe
