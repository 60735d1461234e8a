// Whole-loop fused CRBE solve with the uniform operator and Chebyshev
// iterations: every time step of the solve in ONE launch.
//
// Replaces airpollution_tpu/ops/pallas_solver.py::_uniform_solver_kernel
// (method="chebyshev"), which keeps the whole state in a TPU core's VMEM and
// loops over steps inside the kernel. On Hopper no block can hold the state,
// and blocks cannot be ordered, so this is a cooperative persistent kernel:
// the grid is no larger than the number of co-resident blocks, each block
// walks its output tiles with uniform_span (tile_step.cuh) reading buffer A
// and writing buffer B, then one grid barrier ends the step and the buffers
// swap. One barrier per step (per span, for a step split over `depth`
// spans: x, r and d pass through a work buffer between them); the state
// (0.8 MB per canvas triple at 257^2, f32) stays in the 50 MB L2 between
// steps.
//
// Source loads. The TPU kernel evaluates the problem's source hook inside
// the kernel from iota coordinates; a Python hook cannot be compiled here,
// so the caller builds the load in torch (ops/loads.EmissionLoads) and the
// second entry point (crbe_uniform_solve_load_*) reads step i's plane at
// load + i * load_stride: stride 0 for a steady source (one plane, the TPU
// kernel's hoisted load), 3 n^2 for a stack of per-step planes, which the
// caller launches a window of steps at a time, carrying u and u_prev from
// one launch to the next. The load-free entry point is the kLoad = false
// instantiation, compiled as before loads existed.
//
// What bounds it: per step each block recomputes its halo cells (the window
// is (T + 2h)^2 for a T^2 tile), all from shared memory, plus one grid
// barrier. Device-memory traffic is one read and one write of the state per
// step (plus one read of the load plane) and is far from the limit at the
// sizes this path serves. The tile trades the halo's redundancy against
// the number of blocks that can share the 132 SMs; the caller picks it
// (ops/fused_solver.uniform_plan: 24^2 tiles at 257^2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace cg = cooperative_groups;

namespace crbe {

// The spans of one step, each with its tiling.
struct SolvePlan {
  Tiling t[kMaxDepth];
  Span sp[kMaxDepth];
  int depth;
};

template <int P, typename T, bool kLoad>
__global__ void __launch_bounds__(UniformShape<T>::kThreads, 1)
    uniform_solver_kernel(SolvePlan plan, const T* scal, T* ua, T* ub,
                          T* upa, T* upb, const T* load, size_t load_stride,
                          T* work, int n_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s[kMaxScal];
  T* smem = reinterpret_cast<T*>(smem_raw);
  load_scalars(scal, s, plan.t[0].n_iters);
  const Coefs<T> k = load_coefs(s);
  const size_t plane =
      static_cast<size_t>(plan.t[0].n) * static_cast<size_t>(plan.t[0].n);
  T* bufs[2] = {work, work == nullptr ? nullptr : work + 9 * plane};
  cg::grid_group grid = cg::this_grid();
  for (int step = 0; step < n_steps; ++step) {
    const bool even = (step & 1) == 0;
    StepIO<T> io;
    io.u_in = even ? ua : ub;
    io.u_out = even ? ub : ua;
    io.up_in = upa == nullptr ? nullptr : (even ? upa : upb);
    io.up_out = upa == nullptr ? nullptr : (even ? upb : upa);
    io.load = kLoad ? load + step * load_stride : nullptr;
    for (int j = 0; j < plan.depth; ++j) {
      const Tiling& t = plan.t[j];
      const int n_tiles = t.tile_rows * t.tiles_per_row;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        uniform_span<UniformShape<T>::kThreads, P, T, kLoad, false>(
            t, plan.sp[j], s, k, io, j > 0 ? bufs[(j - 1) & 1] : nullptr,
            plan.sp[j].last ? nullptr : bufs[j & 1], tile, smem);
        __syncthreads();  // the planes of the next tile
      }
      grid.sync();
    }
  }
}

template <typename T, bool kLoad>
int launch_solve(const T* scal, T* ua, T* ub, T* upa, T* upb, const T* load,
                 T* work, int n, int th, int tw, int depth, int n_iters,
                 int use_ka, int n_steps, int load_stride, void* stream,
                 int* grid_out) {
  if (!uniform_fits(false, n, n, 0, 0, n, th, tw, n_iters, use_ka, depth)) {
    return cudaErrorInvalidValue;
  }
  if (kLoad && (load == nullptr || load_stride < 0)) {
    return cudaErrorInvalidValue;
  }
  if (depth > 1 && work == nullptr) return cudaErrorInvalidValue;
  SolvePlan plan;
  plan.depth = depth;
  int n_tiles = 0;
  for (int j = 0; j < depth; ++j) {
    plan.t[j] = span_tiling(false, n, n, 0, 0, n, th, tw, n_iters, use_ka,
                            depth, j, &plan.sp[j]);
    const int tiles = plan.t[j].tile_rows * plan.t[j].tiles_per_row;
    if (tiles > n_tiles) n_tiles = tiles;
  }
  const size_t stride = static_cast<size_t>(load_stride);
  return with_cells<T>(
      window_cells<T>(th, tw, plan.t[0].halo), [&](auto cells) {
        constexpr int P = decltype(cells)::value;
        constexpr int NT = UniformShape<T>::kThreads;
        auto kernel = uniform_solver_kernel<P, T, kLoad>;
        const size_t smem =
            uniform_smem_bytes(th, tw, plan.t[0].halo, sizeof(T));
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        int device = 0, sms = 0, per_sm = 0;
        err = cudaGetDevice(&device);
        if (err != cudaSuccess) return static_cast<int>(err);
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err != cudaSuccess) return static_cast<int>(err);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            NT, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) {
          return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
        }
        int grid = per_sm * sms;
        if (grid > n_tiles) grid = n_tiles;
        *grid_out = grid;
        size_t ls = stride;
        int steps = n_steps;
        T* w = work;
        const T* ld = load;
        void* args[] = {&plan, &scal, &ua, &ub, &upa, &upb,
                        &ld,   &ls,   &w,  &steps};
        err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                          dim3(grid), dim3(NT), args, smem,
                                          static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return static_cast<int>(err);
        return static_cast<int>(cudaGetLastError());
      });
}

}  // namespace crbe

// Every entry point takes the plan's tile rows and columns (th, tw) and
// depth; work holds 9 n^2 values at depth 2, 18 from depth 3 (null at
// depth 1).
extern "C" {

int crbe_uniform_solve_f32(const float* scal, float* ua, float* ub,
                           float* upa, float* upb, float* work, int n,
                           int th, int tw, int depth, int n_iters,
                           int use_ka, int n_steps, void* stream,
                           int* grid_out) {
  return crbe::launch_solve<float, false>(scal, ua, ub, upa, upb, nullptr,
                                          work, n, th, tw, depth, n_iters,
                                          use_ka, n_steps, 0, stream,
                                          grid_out);
}

int crbe_uniform_solve_f64(const double* scal, double* ua, double* ub,
                           double* upa, double* upb, double* work, int n,
                           int th, int tw, int depth, int n_iters,
                           int use_ka, int n_steps, void* stream,
                           int* grid_out) {
  return crbe::launch_solve<double, false>(scal, ua, ub, upa, upb, nullptr,
                                           work, n, th, tw, depth, n_iters,
                                           use_ka, n_steps, 0, stream,
                                           grid_out);
}

int crbe_uniform_solve_load_f32(const float* scal, float* ua, float* ub,
                                float* upa, float* upb, const float* load,
                                float* work, int n, int th, int tw, int depth,
                                int n_iters, int use_ka, int n_steps,
                                int load_stride, void* stream,
                                int* grid_out) {
  return crbe::launch_solve<float, true>(scal, ua, ub, upa, upb, load, work,
                                         n, th, tw, depth, n_iters, use_ka,
                                         n_steps, load_stride, stream,
                                         grid_out);
}

int crbe_uniform_solve_load_f64(const double* scal, double* ua, double* ub,
                                double* upa, double* upb, const double* load,
                                double* work, int n, int th, int tw,
                                int depth, int n_iters, int use_ka,
                                int n_steps, int load_stride, void* stream,
                                int* grid_out) {
  return crbe::launch_solve<double, true>(scal, ua, ub, upa, upb, load, work,
                                          n, th, tw, depth, n_iters, use_ka,
                                          n_steps, load_stride, stream,
                                          grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
