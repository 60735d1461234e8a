// y = A x for a fixed-width (ELL) sparse matrix: the general-mesh SpMV,
// kernel B7, forward and transposed (the transpose is the same product over
// the transposed values, ops/sparse.EllMatvec).
//
// Replaces airpollution_tpu/ops/pallas_gather.py::_gather_kernel (B7a) and
// ::_roll_gather_kernel (B7b). Both hold x resident in one TPU core's VMEM
// and stream (vals, cols) row blocks; Mosaic lowers only same-shape sublane
// gathers, so the TPU kernels reach x through a (rows, 128) two-stage
// gather or 128 lane rolls. A CUDA thread can load any address, so none of
// that is carried over: one thread computes one output row,
//   y[b, r] = sum_k vals[b, r, k] * x[b, cols[r, k]],
// in slot order k = 0 .. width-1 (a fixed order, no atomics), with a
// grid-stride loop over the rows.
//
// What bounds it: device memory. Each row reads width values and width
// int32 columns (contiguous per row, so a warp's rows are one contiguous
// stretch and every fetched line is used) and writes one value; the x
// reads are the gather. x goes through __ldg: at 257^2 (0.8 MB in f32) and
// 1025^2 (12.6 MB) it stays resident in the 50 MB L2, Hopper's counterpart
// of the VMEM residency the TPU kernel wanted, so device memory sees each
// x value about once. Bytes per product: n w (s + 4) + 2 n s, s the element
// size.
//
// Batches: gridDim.y runs over a batch of B right-hand sides, x and y
// (B, n) contiguous. vals advance by op_stride elements per batch entry:
// 0 for one operator shared by the batch, n * width for a stack of B
// operators (the per-species stacks of the multispecies solve, the
// members of an ensemble). The columns do not advance: every stack shares
// one pattern, so it keeps one (n, width) column index for all its
// operators, and moves n * width * 4 bytes of columns less per operator.
//
// The launch: what does not change between products (the columns, n,
// width and op_stride) is a host struct built once per index
// (ops/gather.KernelIndex) and passed by pointer, so a product passes six
// arguments. Blocks of kThreads threads, at most kMaxBlocks of them (16
// on each of the H100's 132 SMs); larger operators take the grid-stride
// loop.

#include <cuda_runtime.h>

namespace crbe {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// The host-side index (ctypes structure ops/gather._Index).
struct EllIndex {
  const int* cols;
  int n;
  int width;
  long long op_stride;  // between the batch's value blocks
};

template <typename T>
__global__ void ell_gather_kernel(const T* __restrict__ vals,
                                  const int* __restrict__ cols,
                                  const T* __restrict__ x, T* __restrict__ y,
                                  int n, int width, long long op_stride) {
  const long long b = blockIdx.y;
  const T* vb = vals + b * op_stride;
  const T* xb = x + b * n;
  T* yb = y + b * n;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += gridDim.x * blockDim.x) {
    const T* vr = vb + static_cast<long long>(r) * width;
    const int* cr = cols + static_cast<long long>(r) * width;
    T acc = T(0);
    for (int k = 0; k < width; ++k) {
      acc += __ldg(vr + k) * __ldg(xb + __ldg(cr + k));
    }
    yb[r] = acc;
  }
}

template <typename T>
int launch_ell_gather(const EllIndex* ix, const T* vals, const T* x, T* y,
                      int batch, void* stream) {
  if (ix == nullptr || ix->n < 1 || ix->width < 1 || batch < 1 ||
      batch > 65535 || ix->op_stride < 0) {
    return cudaErrorInvalidValue;
  }
  long long blocks = (static_cast<long long>(ix->n) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  ell_gather_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          vals, ix->cols, x, y, ix->n, ix->width, ix->op_stride);
  return cudaGetLastError();
}

}  // namespace crbe

extern "C" {

int crbe_ell_gather_f32(const crbe::EllIndex* ix, const float* vals,
                        const float* x, float* y, int batch, void* stream) {
  return crbe::launch_ell_gather<float>(ix, vals, x, y, batch, stream);
}

int crbe_ell_gather_f64(const crbe::EllIndex* ix, const double* vals,
                        const double* x, double* y, int batch,
                        void* stream) {
  return crbe::launch_ell_gather<double>(ix, vals, x, y, batch, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
