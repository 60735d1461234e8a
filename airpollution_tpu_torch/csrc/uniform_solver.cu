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
// What bounds it: per step each block recomputes its halo cells (the window
// is (T + 2h)^2 for a T^2 tile), all from shared memory, plus one grid
// barrier. Device-memory traffic is one read and one write of the state per
// step and is far from the limit at the sizes this path serves. The tile
// edge trades the halo's redundancy against the number of blocks that can
// share the 132 SMs; the caller picks it (ops/fused_solver.choose_tile).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_step.cuh"

namespace cg = cooperative_groups;

namespace crbe {

template <int NT, typename T>
__global__ void __launch_bounds__(NT)
    uniform_solver_kernel(Geometry g, const T* scal, T* ua, T* ub, T* upa,
                          T* upb, int n_steps, int n_tiles) {
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
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      tile_step<NT>(g, s, io, t, smem);
    }
    grid.sync();
  }
}

template <int NT, typename T>
int launch_solve_nt(const T* scal, T* ua, T* ub, T* upa, T* upb, Geometry g,
                    int n_steps, void* stream, int* grid_out) {
  int n_tiles = g.tiles_per_row * g.tiles_per_row;
  const size_t smem = smem_bytes(g.tile, g.halo, sizeof(T));
  auto kernel = uniform_solver_kernel<NT, T>;
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
  void* args[] = {&g, &scal, &ua, &ub, &upa, &upb, &n_steps, &n_tiles};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(NT), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_solve(const T* scal, T* ua, T* ub, T* upa, T* upb, int n,
                 int tile, int halo, int n_iters, int use_ka, int n_steps,
                 int threads, void* stream, int* grid_out) {
  if (n_iters < 1 || n_iters > kMaxIters) return cudaErrorInvalidValue;
  Geometry g;
  g.n = n;
  g.tile = tile;
  g.halo = halo;
  g.tiles_per_row = (n + tile - 1) / tile;
  g.n_iters = n_iters;
  g.use_ka = use_ka;
  if (threads == 256) {
    return launch_solve_nt<256>(scal, ua, ub, upa, upb, g, n_steps, stream,
                                grid_out);
  }
  if (threads == 512) {
    return launch_solve_nt<512>(scal, ua, ub, upa, upb, g, n_steps, stream,
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
  return crbe::launch_solve<float>(scal, ua, ub, upa, upb, n, tile, halo,
                                   n_iters, use_ka, n_steps, threads, stream,
                                   grid_out);
}

int crbe_uniform_solve_f64(const double* scal, double* ua, double* ub,
                           double* upa, double* upb, int n, int tile, int halo,
                           int n_iters, int use_ka, int n_steps, int threads,
                           void* stream, int* grid_out) {
  return crbe::launch_solve<double>(scal, ua, ub, upa, upb, n, tile, halo,
                                    n_iters, use_ka, n_steps, threads, stream,
                                    grid_out);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
