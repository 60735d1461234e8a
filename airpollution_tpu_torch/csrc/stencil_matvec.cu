// y = A x in family layout with per-DOF coefficients: the structured CR
// stencil matvec of the scan path (matvec_impl="pallas"), kernel B3.
//
// Replaces airpollution_tpu/ops/pallas_stencil.py::_stencil_kernel, which
// holds all 15 coefficient grids and x, y in one TPU core's VMEM and forms
// the 15 shift-multiply-add terms with pads. Here one thread computes one
// output DOF: it reads the five coefficients of its row and the five
// entries of x they multiply, on the unpadded family grids H (n x c),
// V (c x n), D (c x c), c = n - 1, laid out one after another as in
// ops/stencil.py. A neighbour outside its family grid contributes 0, the
// zero padding of the plain version (ops/stencil.stencil_matvec).
//
// What bounds it: device memory. Each output reads 5 coefficients and
// writes 1 value; x is read by up to 5 neighbours but neighbouring threads
// share cache lines, so device memory sees each coefficient and x once:
// (15 coefficient grids + x + y) x ~n^2 x sizeof(T), 5.5 MB at 257^2 in
// f32, which the 50 MB L2 holds across the launches of a solve.
// Consecutive threads take consecutive DOFs of one family row, so every
// coefficient and x load is coalesced.
//
// Design. A 1-D grid of kThreads-thread blocks over the DOFs of the three
// family grids in turn: no thread or block is idle but the last block's
// tail. The operator (15 coefficient pointers and n) is a host struct
// built once per operator (ops/fused_stencil.StencilOperator) and passed
// by pointer; the launcher copies it into the kernel's parameters, so a
// launch takes four arguments. A 2-D variant (32 x 8 tiles, one per
// block, no per-thread division) measured 10-13% slower at 257^2 on an
// NVIDIA H100 80GB HBM3 at 700 W: at n = 2^k + 1 its partial and empty
// tiles launch 13% more threads than there are DOFs (PERF.md).

#include <cuda_runtime.h>

namespace crbe {

constexpr int kThreads = 256;

// The host-side operator, built once per coefficient tuple (ctypes
// structure ops/fused_stencil._Operator).
struct StencilOperator {
  const void* coefs[15];  // cHH cHVu cHDu cHVd cHDd  cVV cVDl cVHl cVHr cVDr
                          // cDD cDVr cDHd cDHu cDVl (ops/stencil.py order)
  int n;
};

template <typename T>
struct StencilCoefs {
  const T* c[15];
};

// 32-bit index arithmetic (the launch refuses a canvas past 2^31 DOFs):
// the divisions that map a DOF to its (row, column) are the kernel's most
// expensive instructions.
template <typename T>
__global__ void stencil_matvec_kernel(StencilCoefs<T> k, const T* __restrict__ x,
                                      T* __restrict__ y, int n) {
  const int c = n - 1;
  const int nH = n * c;  // H (n x c); V (c x n) has as many
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= 2 * nH + c * c) return;
  const T* xH = x;
  const T* xV = x + nH;
  const T* xD = x + 2 * nH;
  T acc;
  if (q < nH) {  // H row (i, j): i < n, j < c
    const int i = q / c, j = q - (q / c) * c;
    acc = __ldg(k.c[0] + q) * xH[q];
    if (i < c) {
      acc += __ldg(k.c[1] + q) * xV[i * n + j + 1];
      acc += __ldg(k.c[2] + q) * xD[i * c + j];
    }
    if (i >= 1) {
      acc += __ldg(k.c[3] + q) * xV[(i - 1) * n + j];
      acc += __ldg(k.c[4] + q) * xD[(i - 1) * c + j];
    }
  } else if (q < 2 * nH) {  // V row (i, j): i < c, j < n
    const int p = q - nH;
    const int i = p / n, j = p - (p / n) * n;
    acc = __ldg(k.c[5] + p) * xV[p];
    if (j >= 1) {
      acc += __ldg(k.c[6] + p) * xD[i * c + j - 1];
      acc += __ldg(k.c[7] + p) * xH[i * c + j - 1];
    }
    if (j < c) {
      acc += __ldg(k.c[8] + p) * xH[(i + 1) * c + j];
      acc += __ldg(k.c[9] + p) * xD[i * c + j];
    }
  } else {  // D row (i, j): i, j < c
    const int p = q - 2 * nH;
    const int i = p / c, j = p - (p / c) * c;
    acc = __ldg(k.c[10] + p) * xD[p];
    acc += __ldg(k.c[11] + p) * xV[i * n + j + 1];
    acc += __ldg(k.c[12] + p) * xH[i * c + j];
    acc += __ldg(k.c[13] + p) * xH[(i + 1) * c + j];
    acc += __ldg(k.c[14] + p) * xV[i * n + j];
  }
  y[q] = acc;
}

template <typename T>
int launch_matvec(const StencilOperator* op, const T* x, T* y, void* stream) {
  if (op == nullptr) return cudaErrorInvalidValue;
  const long n = op->n, c = n - 1;
  const long total = 2 * n * c + c * c;
  if (n < 2 || total >= (1L << 31)) return cudaErrorInvalidValue;
  StencilCoefs<T> k;
  for (int t = 0; t < 15; ++t) k.c[t] = static_cast<const T*>(op->coefs[t]);
  const long blocks = (total + kThreads - 1) / kThreads;
  stencil_matvec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(k, x, y,
                                                                  op->n);
  return cudaGetLastError();
}

}  // namespace crbe

extern "C" {

int crbe_stencil_matvec_f32(const crbe::StencilOperator* op, const float* x,
                            float* y, void* stream) {
  return crbe::launch_matvec<float>(op, x, y, stream);
}

int crbe_stencil_matvec_f64(const crbe::StencilOperator* op, const double* x,
                            double* y, void* stream) {
  return crbe::launch_matvec<double>(op, x, y, stream);
}

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
