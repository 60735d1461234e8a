// Whole-loop fused CRBE solve with the per-DOF canvas operator and fixed-k
// BiCGStab: every time step of the solve in ONE launch.
//
// Replaces airpollution_tpu/ops/pallas_solver.py::_solver_kernel, which
// keeps every canvas (15 coefficients, masked mass, inverse diagonal,
// interior mask, state and six Krylov vectors) in one TPU core's VMEM and
// loops over steps and iterations inside the kernel. On Hopper no block
// holds the state, so this is a cooperative persistent kernel: the grid is
// no larger than the number of co-resident blocks, every thread owns the
// same canvas cells (all three families of each) for the whole solve, and
// a grid barrier (cg::grid_group::sync, which fences memory) separates
// each phase that reads what other blocks wrote. The state, the six Krylov
// canvases and the operator (about 13.5 MB at 257^2 in f32) stay in the
// 50 MB L2; values other blocks wrote are loaded with __ldcg (L1 is not
// coherent across SMs), the operator, which never changes, with __ldg.
//
// One step (the JAX kernel's arithmetic, Jacobi right preconditioning,
// _EPS = 1e-30 substituted for a zero denominator where the JAX kernel
// does):
//
//   [CN]  t = S u; r = 2 M u + (1 - mask) u - t                    | sync
//         r = M u (BE); u = mask (2 u - u_prev), u_prev = u
//         (or u = mask u)                                          | sync
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
// version (ops/fused_solver.plain_bicgstab_solve), so that the kernel and
// its plain version differ only by the rounding of the vector updates, not
// by the order of their sums. (A fixed-k BiCGStab iterate keeps iterating
// at rounding level, and in float some configurations amplify any
// rounding difference: chip_smoke.py's phase_b5 measures and prints it.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace crbe {

constexpr int kMaxGrid = 2048;  // partial-sum slots per reduction

template <typename T>
struct SolverIO {
  const T* C;  // (24, n, n): 15 coefficients, 3 mass, 3 inv diag, 3 mask
  T* u;        // (3, n, n) state, u0 on entry
  T* up;       // (3, n, n) previous state, u0 on entry, or nullptr
  T* r;
  T* rh;
  T* p;
  T* v;
  T* t;
  T* w;
  double* part;  // (4, kMaxGrid): rho, (rhat, v), (t, t), (t, r)
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
__device__ double grid_total(const double* part, int G, double* red) {
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

// y = S x for the three families of canvas cell (i, j), x read through L2.
template <typename T>
__device__ __forceinline__ void apply_cell(const T* __restrict__ C,
                                           const T* x, int n, int i, int j,
                                           T y[3]) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t q = static_cast<size_t>(i) * n + j;
  const T* H = x;
  const T* V = x + nn;
  const T* D = x + 2 * nn;
  const bool up = i >= 1, down = i + 1 < n, left = j >= 1, right = j + 1 < n;
  const T h0 = __ldcg(H + q);
  const T hl = left ? __ldcg(H + q - 1) : T(0);
  const T hd = down ? __ldcg(H + q + n) : T(0);
  const T v0 = __ldcg(V + q);
  const T vr = right ? __ldcg(V + q + 1) : T(0);
  const T vu = up ? __ldcg(V + q - n) : T(0);
  const T d0 = __ldcg(D + q);
  const T dl = left ? __ldcg(D + q - 1) : T(0);
  const T du = up ? __ldcg(D + q - n) : T(0);
  const T* c = C + q;
  y[0] = __ldg(c) * h0 + __ldg(c + nn) * vr + __ldg(c + 2 * nn) * d0 +
         __ldg(c + 3 * nn) * vu + __ldg(c + 4 * nn) * du;
  y[1] = __ldg(c + 5 * nn) * v0 + __ldg(c + 6 * nn) * dl +
         __ldg(c + 7 * nn) * hl + __ldg(c + 8 * nn) * hd +
         __ldg(c + 9 * nn) * d0;
  y[2] = __ldg(c + 10 * nn) * d0 + __ldg(c + 11 * nn) * vr +
         __ldg(c + 12 * nn) * h0 + __ldg(c + 13 * nn) * hd +
         __ldg(c + 14 * nn) * v0;
}

template <int NT, typename T>
__global__ void __launch_bounds__(NT)
    canvas_solver_kernel(SolverIO<T> io, int n, int n_steps, int n_iters,
                         int use_ka) {
  __shared__ double red[34];
  cg::grid_group grid = cg::this_grid();
  const size_t nn = static_cast<size_t>(n) * n;
  const int G = gridDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  const size_t stride = static_cast<size_t>(G) * NT;
  const T* C = io.C;
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
        apply_cell(C, io.u, n, i, j, y);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const size_t o = f * nn + q;
          const T u = ld(io.u + o);
          io.r[o] = T(2) * __ldg(C + (15 + f) * nn + q) * u +
                    (T(1) - __ldg(C + (21 + f) * nn + q)) * u - y[f];
        }
      });
      grid.sync();
    }
    for_cells([&](size_t q, int, int) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const size_t o = f * nn + q;
        const T u = ld(io.u + o);
        const T mk = __ldg(C + (21 + f) * nn + q);
        if (!use_ka) io.r[o] = __ldg(C + (15 + f) * nn + q) * u;
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
      apply_cell(C, io.u, n, i, j, y);
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
          io.w[o] = __ldg(C + (18 + f) * nn + q) * p;
        }
      });
      grid.sync();

      acc = 0.0;
      for_cells([&](size_t q, int i, int j) {
        T y[3];
        apply_cell(C, io.w, n, i, j, y);
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
          io.w[o] = __ldg(C + (18 + f) * nn + q) * r;
        }
      });
      grid.sync();

      double acc_tt = 0.0, acc_tr = 0.0;
      for_cells([&](size_t q, int i, int j) {
        T y[3];
        apply_cell(C, io.w, n, i, j, y);
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

template <int NT, typename T>
int launch_solve_nt(SolverIO<T> io, int n, int n_steps, int n_iters,
                    int use_ka, void* stream, int* grid_out) {
  auto kernel = canvas_solver_kernel<NT, T>;
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
  void* args[] = {&io, &n, &n_steps, &n_iters, &use_ka};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(NT),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_solve(const T* C, T* u, T* up, T* work, double* partials, int n,
                 int n_steps, int n_iters, int use_ka, int threads,
                 void* stream, int* grid_out) {
  if (n < 2 || n_iters < 1) return cudaErrorInvalidValue;
  const size_t plane = 3 * static_cast<size_t>(n) * n;
  SolverIO<T> io;
  io.C = C;
  io.u = u;
  io.up = up;
  io.r = work;
  io.rh = work + plane;
  io.p = work + 2 * plane;
  io.v = work + 3 * plane;
  io.t = work + 4 * plane;
  io.w = work + 5 * plane;
  io.part = partials;
  if (threads == 256) {
    return launch_solve_nt<256>(io, n, n_steps, n_iters, use_ka, stream,
                                grid_out);
  }
  if (threads == 512) {
    return launch_solve_nt<512>(io, n, n_steps, n_iters, use_ka, stream,
                                grid_out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace crbe

extern "C" {

int crbe_canvas_solve_f32(const float* C, float* u, float* up, float* work,
                          double* partials, int n, int n_steps, int n_iters,
                          int use_ka, int threads, void* stream,
                          int* grid_out) {
  return crbe::launch_solve<float>(C, u, up, work, partials, n, n_steps,
                                   n_iters, use_ka, threads, stream, grid_out);
}

int crbe_canvas_solve_f64(const double* C, double* u, double* up,
                          double* work, double* partials, int n, int n_steps,
                          int n_iters, int use_ka, int threads, void* stream,
                          int* grid_out) {
  return crbe::launch_solve<double>(C, u, up, work, partials, n, n_steps,
                                    n_iters, use_ka, threads, stream,
                                    grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
