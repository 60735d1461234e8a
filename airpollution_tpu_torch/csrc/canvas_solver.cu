// Whole-loop fused CRBE solve with the per-DOF canvas operator and fixed-k
// BiCGStab (kernel B5): every time step of the solve in ONE launch.
//
// Replaces airpollution_tpu/ops/pallas_solver.py::_solver_kernel, which
// keeps every canvas (15 coefficients, masked mass, inverse diagonal,
// interior mask, state and six Krylov vectors) in one TPU core's VMEM. The
// loop, its grid barriers and its fixed-order dot products are
// bicgstab_loop.cuh's; this file supplies the operator: a (24, n, n) stack
// of 15 coefficient canvases of the masked system, the masked mass, the
// inverse diagonal and the interior mask, read through the read-only path
// (__ldg: it never changes during a solve). Zero source, as the JAX kernel.
//
// Crank-Nicolson needs no extra coefficients: with P = diag(interior),
// B = I - P and the masked system S = P (M + (dt/2) ka) + B, the CN RHS is
// b = 2 M_masked u + B u - S u.
//
// What bounds it: 27 grid barriers per step (28 CN) at k = 5; the operator
// (13.5 MB at 257^2 in f32 with the state and Krylov canvases) stays in L2.

#include "bicgstab_loop.cuh"

namespace crbe {

template <typename T>
struct CanvasOp {
  const T* C;  // (24, n, n)
  int n;
  size_t nn;

  __device__ __forceinline__ void load() {}
  __device__ __forceinline__ T coef(int k, size_t q) const {
    return __ldg(C + k * nn + q);
  }
  __device__ __forceinline__ void apply(const T* x, int i, int j, size_t q,
                                        T y[3]) const {
    const Neighbours<T> a = neighbours(x, n, i, j);
    const T* c = C + q;
    y[0] = __ldg(c) * a.h0 + __ldg(c + nn) * a.vr + __ldg(c + 2 * nn) * a.d0 +
           __ldg(c + 3 * nn) * a.vu + __ldg(c + 4 * nn) * a.du;
    y[1] = __ldg(c + 5 * nn) * a.v0 + __ldg(c + 6 * nn) * a.dl +
           __ldg(c + 7 * nn) * a.hl + __ldg(c + 8 * nn) * a.hd +
           __ldg(c + 9 * nn) * a.d0;
    y[2] = __ldg(c + 10 * nn) * a.d0 + __ldg(c + 11 * nn) * a.vr +
           __ldg(c + 12 * nn) * a.h0 + __ldg(c + 13 * nn) * a.hd +
           __ldg(c + 14 * nn) * a.v0;
  }
  __device__ __forceinline__ T mask(int f, int, int, size_t q) const {
    return coef(21 + f, q);
  }
  __device__ __forceinline__ T idiag(int f, size_t q) const {
    return coef(18 + f, q);
  }
  __device__ __forceinline__ T be_rhs(int f, T u, int, int, size_t q) const {
    return coef(15 + f, q) * u;
  }
  __device__ __forceinline__ T cn_rhs(int f, T u, T y, int, int,
                                      size_t q) const {
    return T(2) * coef(15 + f, q) * u + (T(1) - coef(21 + f, q)) * u - y;
  }
};

template <typename T>
int launch_canvas_solve(const T* C, T* u, T* up, T* work, double* partials,
                        int n, int n_steps, int n_iters, int use_ka,
                        int threads, void* stream, int* grid_out) {
  CanvasOp<T> op{C, n, static_cast<size_t>(n) * n};
  return launch_bicgstab<T>(op, u, up, work, partials, nullptr, 0, n,
                            n_steps, n_iters, use_ka, threads, stream,
                            grid_out);
}

}  // namespace crbe

extern "C" {

int crbe_canvas_solve_f32(const float* C, float* u, float* up, float* work,
                          double* partials, int n, int n_steps, int n_iters,
                          int use_ka, int threads, void* stream,
                          int* grid_out) {
  return crbe::launch_canvas_solve<float>(C, u, up, work, partials, n,
                                          n_steps, n_iters, use_ka, threads,
                                          stream, grid_out);
}

int crbe_canvas_solve_f64(const double* C, double* u, double* up,
                          double* work, double* partials, int n, int n_steps,
                          int n_iters, int use_ka, int threads, void* stream,
                          int* grid_out) {
  return crbe::launch_canvas_solve<double>(C, u, up, work, partials, n,
                                           n_steps, n_iters, use_ka, threads,
                                           stream, grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
