// Whole-loop fused CRBE solve with the uniform operator and Chebyshev
// iterations: every time step of the solve in ONE launch.
//
// Replaces airpollution_tpu/ops/pallas_solver.py::_uniform_solver_kernel
// (method="chebyshev"), which keeps the whole state in a TPU core's VMEM and
// loops over steps inside the kernel. On Hopper no block can hold the state,
// and blocks cannot be ordered, so this is a cooperative persistent kernel:
// the grid is no larger than the number of co-resident blocks, each block
// walks its output tiles with tile_step (tile_step.cuh) reading buffer A and
// writing buffer B, then one grid barrier ends the step and the buffers
// swap. One barrier per step; the state (0.8 MB per canvas triple at 257^2,
// f32) stays in the 50 MB L2 between steps.
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
// sizes this path serves. The tile edge trades the halo's redundancy against
// the number of blocks that can share the 132 SMs; the caller picks it
// (ops/fused_solver.choose_tile).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace cg = cooperative_groups;

namespace crbe {

template <int NT, typename T, bool kLoad>
__global__ void __launch_bounds__(NT)
    uniform_solver_kernel(Geometry g, const T* scal, T* ua, T* ub, T* upa,
                          T* upb, const T* load, size_t load_stride,
                          int n_steps, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s[kMaxScal];
  T* smem = reinterpret_cast<T*>(smem_raw);
  load_scalars(scal, s, g.n_iters);
  cg::grid_group grid = cg::this_grid();
  for (int step = 0; step < n_steps; ++step) {
    const bool even = (step & 1) == 0;
    StepIO<T> io;
    io.u_in = even ? ua : ub;
    io.u_out = even ? ub : ua;
    io.up_in = upa == nullptr ? nullptr : (even ? upa : upb);
    io.up_out = upa == nullptr ? nullptr : (even ? upb : upa);
    io.load = kLoad ? load + step * load_stride : nullptr;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      tile_step<NT, T, kLoad>(g, s, io, t, smem);
    }
    grid.sync();
  }
}

template <int NT, typename T, bool kLoad>
int launch_solve_nt(const T* scal, T* ua, T* ub, T* upa, T* upb,
                    const T* load, size_t load_stride, Geometry g,
                    int n_steps, void* stream, int* grid_out) {
  int n_tiles = g.tiles_per_row * g.tiles_per_row;
  const size_t smem = smem_bytes(g.tile, g.halo, sizeof(T));
  auto kernel = uniform_solver_kernel<NT, T, kLoad>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  if (grid > n_tiles) grid = n_tiles;
  *grid_out = grid;
  void* args[] = {&g,    &scal,        &ua,      &ub,     &upa,
                  &upb,  &load,        &load_stride, &n_steps, &n_tiles};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(NT), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kLoad>
int launch_solve(const T* scal, T* ua, T* ub, T* upa, T* upb, const T* load,
                 int n, int tile, int halo, int n_iters, int use_ka,
                 int n_steps, int load_stride, int threads, void* stream,
                 int* grid_out) {
  if (n_iters < 1 || n_iters > kMaxIters) return cudaErrorInvalidValue;
  if (kLoad && (load == nullptr || load_stride < 0)) {
    return cudaErrorInvalidValue;
  }
  Geometry g;
  g.n = n;
  g.tile = tile;
  g.halo = halo;
  g.tiles_per_row = (n + tile - 1) / tile;
  g.n_iters = n_iters;
  g.use_ka = use_ka;
  const size_t stride = static_cast<size_t>(load_stride);
  if (threads == 256) {
    return launch_solve_nt<256, T, kLoad>(scal, ua, ub, upa, upb, load,
                                          stride, g, n_steps, stream,
                                          grid_out);
  }
  if (threads == 512) {
    return launch_solve_nt<512, T, kLoad>(scal, ua, ub, upa, upb, load,
                                          stride, g, n_steps, stream,
                                          grid_out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace crbe

extern "C" {

int crbe_uniform_solve_f32(const float* scal, float* ua, float* ub,
                           float* upa, float* upb, int n, int tile, int halo,
                           int n_iters, int use_ka, int n_steps, int threads,
                           void* stream, int* grid_out) {
  return crbe::launch_solve<float, false>(scal, ua, ub, upa, upb, nullptr, n,
                                          tile, halo, n_iters, use_ka,
                                          n_steps, 0, threads, stream,
                                          grid_out);
}

int crbe_uniform_solve_f64(const double* scal, double* ua, double* ub,
                           double* upa, double* upb, int n, int tile, int halo,
                           int n_iters, int use_ka, int n_steps, int threads,
                           void* stream, int* grid_out) {
  return crbe::launch_solve<double, false>(scal, ua, ub, upa, upb, nullptr, n,
                                           tile, halo, n_iters, use_ka,
                                           n_steps, 0, threads, stream,
                                           grid_out);
}

int crbe_uniform_solve_load_f32(const float* scal, float* ua, float* ub,
                                float* upa, float* upb, const float* load,
                                int n, int tile, int halo, int n_iters,
                                int use_ka, int n_steps, int load_stride,
                                int threads, void* stream, int* grid_out) {
  return crbe::launch_solve<float, true>(scal, ua, ub, upa, upb, load, n,
                                         tile, halo, n_iters, use_ka, n_steps,
                                         load_stride, threads, stream,
                                         grid_out);
}

int crbe_uniform_solve_load_f64(const double* scal, double* ua, double* ub,
                                double* upa, double* upb, const double* load,
                                int n, int tile, int halo, int n_iters,
                                int use_ka, int n_steps, int load_stride,
                                int threads, void* stream, int* grid_out) {
  return crbe::launch_solve<double, true>(scal, ua, ub, upa, upb, load, n,
                                          tile, halo, n_iters, use_ka,
                                          n_steps, load_stride, threads,
                                          stream, grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
