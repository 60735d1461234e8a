// Whole-loop fused CRBE solve with the uniform operator and fixed-k
// BiCGStab: kernel B1's BiCGStab variant, every step in ONE launch.
//
// Replaces airpollution_tpu/ops/pallas_solver.py::_uniform_solver_kernel
// with method="bicgstab" (the JAX CRBESolver's default solver_method on the
// fused path). BiCGStab needs four grid-wide dot products per iteration,
// so every matvec reads its neighbours' fresh values: the shrinking-square
// tiles of the Chebyshev variant (uniform_solver.cu) do not apply. The loop
// is kernel B5's (bicgstab_loop.cuh: cooperative, one grid barrier per
// phase, per-block partials summed in one fixed order in double); the
// operator here is the 21 scalars of ops/uniform.py, read once into
// registers at the start of the launch: 15
// stencil coefficients, 3 interior mass and 3 inverse-diagonal constants,
// with the per-family interior rectangles computed from the cell indices
// (H rows [1, c) x cols [0, c), V rows [0, c) x cols [1, c), D [0, c)^2):
//
//   S x  = mask (stencil x)            (zero on Dirichlet rows and padding)
//   b    = M mask(u)                   (backward Euler)
//   b    = 2 M mask(u) - S u           (Crank-Nicolson)
//   b   += load                        (optional source load)
//
// The load is built by the caller in torch (ops/loads.EmissionLoads), as
// for the Chebyshev variant: step i's plane at load + i * load_stride
// (stride 0 for a steady source).
//
// What bounds it: the grid barriers, 27 per step at k = 5 (28 CN), as B5;
// it reads no operator canvases, so its L2 traffic is the state and the six
// Krylov canvases only.

#include "bicgstab_loop.cuh"

namespace crbe {

template <typename T>
struct UniformOp {
  const T* s;  // the 21 scalars on the device
  int n;
  T c[15];
  T mass[3];
  T id[3];

  __device__ __forceinline__ void load() {
#pragma unroll
    for (int i = 0; i < 15; ++i) c[i] = __ldg(s + i);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      mass[f] = __ldg(s + 15 + f);
      id[f] = __ldg(s + 18 + f);
    }
  }

  __device__ __forceinline__ T mask(int f, int i, int j, size_t) const {
    const int cc = n - 1;
    const bool in_d = i < cc && j < cc;
    if (f == 0) return (in_d && i >= 1) ? T(1) : T(0);
    if (f == 1) return (in_d && j >= 1) ? T(1) : T(0);
    return in_d ? T(1) : T(0);
  }
  __device__ __forceinline__ void apply(const T* x, int i, int j, size_t q,
                                        T y[3]) const {
    const Neighbours<T> a = neighbours(x, n, i, j);
    y[0] = mask(0, i, j, q) * (c[0] * a.h0 + c[1] * a.vr + c[2] * a.d0 +
                               c[3] * a.vu + c[4] * a.du);
    y[1] = mask(1, i, j, q) * (c[5] * a.v0 + c[6] * a.dl + c[7] * a.hl +
                               c[8] * a.hd + c[9] * a.d0);
    y[2] = mask(2, i, j, q) * (c[10] * a.d0 + c[11] * a.vr + c[12] * a.h0 +
                               c[13] * a.hd + c[14] * a.v0);
  }
  __device__ __forceinline__ T idiag(int f, size_t) const { return id[f]; }
  __device__ __forceinline__ T be_rhs(int f, T u, int i, int j,
                                      size_t q) const {
    return mass[f] * (mask(f, i, j, q) * u);
  }
  __device__ __forceinline__ T cn_rhs(int f, T u, T y, int i, int j,
                                      size_t q) const {
    return T(2) * be_rhs(f, u, i, j, q) - y;
  }
};

template <typename T>
int launch_uniform_bicgstab(const T* scal, T* u, T* up, T* work,
                            double* partials, const T* load, int n,
                            int n_steps, int n_iters, int use_ka,
                            int load_stride, int threads, void* stream,
                            int* grid_out) {
  UniformOp<T> op;
  op.s = scal;
  op.n = n;
  return launch_bicgstab<T>(op, u, up, work, partials, load, load_stride, n,
                            n_steps, n_iters, use_ka, threads, stream,
                            grid_out);
}

}  // namespace crbe

extern "C" {

int crbe_uniform_bicgstab_f32(const float* scal, float* u, float* up,
                              float* work, double* partials,
                              const float* load, int n, int n_steps,
                              int n_iters, int use_ka, int load_stride,
                              int threads, void* stream, int* grid_out) {
  return crbe::launch_uniform_bicgstab<float>(scal, u, up, work, partials,
                                              load, n, n_steps, n_iters,
                                              use_ka, load_stride, threads,
                                              stream, grid_out);
}

int crbe_uniform_bicgstab_f64(const double* scal, double* u, double* up,
                              double* work, double* partials,
                              const double* load, int n, int n_steps,
                              int n_iters, int use_ka, int load_stride,
                              int threads, void* stream, int* grid_out) {
  return crbe::launch_uniform_bicgstab<double>(scal, u, up, work, partials,
                                               load, n, n_steps, n_iters,
                                               use_ka, load_stride, threads,
                                               stream, grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
