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
// (__ldg: it never changes during a solve). In register mode each thread
// reads its cells' 15 coefficients and inverse diagonal once per solve
// (Cell), the mass and mask once per step; a matvec phase reads a
// neighbour's inverse diagonal (and the first phase of a step its mask) at
// the neighbour. Zero source, as the JAX kernel.
//
// Crank-Nicolson needs no extra coefficients: with P = diag(interior),
// B = I - P and the masked system S = P (M + (dt/2) ka) + B, the CN RHS is
// b = 2 M_masked u + B u - S u.
//
// What bounds it: 16 grid barriers per step at k = 5; the operator (13.5 MB
// at 257^2 in f32 with the state and Krylov canvases) stays in L2.

#include "bicgstab_loop.cuh"

namespace crbe {

template <typename T>
struct CanvasOp {
  // Register mode holds 18 operator values per cell: one cell (two
  // spilled and ran slower than global mode at 257^2 on an H100).
  static constexpr int kMaxCells = 1;
  const T* C;  // (24, n, n)
  int n;
  size_t nn;

  // One cell's operator values that every iteration reads: the 15
  // coefficients and the inverse diagonal (the mass and the interior mask,
  // read once per step, stay in device memory).
  struct Cell {
    T c[15];
    T id[3];
  };

  __device__ __forceinline__ void load() {}
  __device__ __forceinline__ Cell cell(size_t q, int, int) const {
    Cell c;
#pragma unroll
    for (int i = 0; i < 15; ++i) c.c[i] = __ldg(C + i * nn + q);
#pragma unroll
    for (int f = 0; f < 3; ++f) c.id[f] = __ldg(C + (18 + f) * nn + q);
    return c;
  }
  __device__ __forceinline__ void apply(const Cell& k, const Neighbours<T>& a,
                                        int, int, T y[3]) const {
    const T* c = k.c;
    y[0] = c[0] * a.h0 + c[1] * a.vr + c[2] * a.d0 + c[3] * a.vu +
           c[4] * a.du;
    y[1] = c[5] * a.v0 + c[6] * a.dl + c[7] * a.hl + c[8] * a.hd +
           c[9] * a.d0;
    y[2] = c[10] * a.d0 + c[11] * a.vr + c[12] * a.h0 + c[13] * a.hd +
           c[14] * a.v0;
  }
  __device__ __forceinline__ T mask_at(int f, size_t q, int, int) const {
    return __ldg(C + (21 + f) * nn + q);
  }
  __device__ __forceinline__ T mask(const Cell&, int f, size_t q, int i,
                                    int j) const {
    return mask_at(f, q, i, j);
  }
  __device__ __forceinline__ T idiag(const Cell& k, int f) const {
    return k.id[f];
  }
  __device__ __forceinline__ T idiag_at(int f, size_t q) const {
    return __ldg(C + (18 + f) * nn + q);
  }
  __device__ __forceinline__ T be_rhs(const Cell&, int f, size_t q,
                                      T u) const {
    return __ldg(C + (15 + f) * nn + q) * u;
  }
  __device__ __forceinline__ T cn_rhs(const Cell&, int f, size_t q, T u,
                                      T y) const {
    return T(2) * __ldg(C + (15 + f) * nn + q) * u +
           (T(1) - __ldg(C + (21 + f) * nn + q)) * u - y;
  }
};

template <typename T>
int launch_canvas_solve(const T* C, T* u, T* up, T* work, double* partials,
                        int n, int n_steps, int n_iters, int use_ka,
                        int cells, void* stream, int* grid_out) {
  CanvasOp<T> op{C, n, static_cast<size_t>(n) * n};
  return launch_bicgstab<T>(op, u, up, work, partials, nullptr, 0, n,
                            n_steps, n_iters, use_ka, cells, stream,
                            grid_out);
}

}  // namespace crbe

extern "C" {

int crbe_canvas_solve_f32(const float* C, float* u, float* up, float* work,
                          double* partials, int n, int n_steps, int n_iters,
                          int use_ka, int cells, void* stream,
                          int* grid_out) {
  return crbe::launch_canvas_solve<float>(C, u, up, work, partials, n,
                                          n_steps, n_iters, use_ka, cells,
                                          stream, grid_out);
}

int crbe_canvas_solve_f64(const double* C, double* u, double* up,
                          double* work, double* partials, int n, int n_steps,
                          int n_iters, int use_ka, int cells, void* stream,
                          int* grid_out) {
  return crbe::launch_canvas_solve<double>(C, u, up, work, partials, n,
                                           n_steps, n_iters, use_ka, cells,
                                           stream, grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
