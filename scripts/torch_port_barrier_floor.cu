// The empty-barrier floor of the BiCGStab whole loop
// (airpollution_tpu_torch/csrc/bicgstab_loop.cuh): n_syncs grid barriers
// and nothing else, on `grid` cooperative blocks of the loop's 512
// threads, with the loop's hand-built barrier (cg = 0) or cooperative
// groups' grid sync (cg = 1). Built with -I to the package's csrc and timed
// by scripts/torch_port_ab.py --sweep; no solver path uses it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bicgstab_loop.cuh"

namespace crbe {

template <bool kCg>
__global__ void __launch_bounds__(kBicgstabThreads, 1)
    barrier_floor_kernel(unsigned* count, int n_syncs) {
  GridBarrier bar{count, 0};
  for (int i = 0; i < n_syncs; ++i) {
    if constexpr (kCg) {
      cooperative_groups::this_grid().sync();
    } else {
      bar.sync();
    }
  }
}

template <bool kCg>
int launch_barrier_floor(unsigned* counter, int grid, int n_syncs,
                         void* stream) {
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(unsigned),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  auto kernel = barrier_floor_kernel<kCg>;
  void* args[] = {&counter, &n_syncs};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                  dim3(kBicgstabThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace crbe

extern "C" {

int crbe_barrier_floor(unsigned* counter, int grid, int n_syncs, int cg,
                       void* stream) {
  return cg ? crbe::launch_barrier_floor<true>(counter, grid, n_syncs, stream)
            : crbe::launch_barrier_floor<false>(counter, grid, n_syncs,
                                                stream);
}

}  // extern "C"
