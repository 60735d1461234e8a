// y = A x in family layout with per-DOF coefficients: the structured CR
// stencil matvec of the scan path (matvec_impl="pallas").
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
// f32. Consecutive threads take consecutive DOFs of one family row, so
// every coefficient and x load is coalesced.

#include <cuda_runtime.h>

namespace crbe {

template <typename T>
struct StencilCoefs {
  const T* c[15];  // cHH cHVu cHDu cHVd cHDd  cVV cVDl cVHl cVHr cVDr
                   // cDD cDVr cDHd cDHu cDVl (ops/stencil.py order)
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
int launch_matvec(const T* const* coefs, const T* x, T* y, int n, int threads,
                  void* stream) {
  const long c = n - 1;
  const long total = 2 * static_cast<long>(n) * c + c * c;
  if (n < 2 || threads < 32 || threads > 1024 || total >= (1L << 31)) {
    return cudaErrorInvalidValue;
  }
  StencilCoefs<T> k;
  for (int t = 0; t < 15; ++t) k.c[t] = coefs[t];
  const long blocks = (total + threads - 1) / threads;
  stencil_matvec_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(k, x, y, n);
  return cudaGetLastError();
}

}  // namespace crbe

extern "C" {

#define CRBE_STENCIL_ENTRY(NAME, T)                                          \
  int NAME(const T* c0, const T* c1, const T* c2, const T* c3, const T* c4,  \
           const T* c5, const T* c6, const T* c7, const T* c8, const T* c9,  \
           const T* c10, const T* c11, const T* c12, const T* c13,           \
           const T* c14, const T* x, T* y, int n, int threads,               \
           void* stream) {                                                   \
    const T* coefs[15] = {c0, c1, c2,  c3,  c4,  c5,  c6, c7,                \
                          c8, c9, c10, c11, c12, c13, c14};                  \
    return crbe::launch_matvec<T>(coefs, x, y, n, threads, stream);          \
  }

CRBE_STENCIL_ENTRY(crbe_stencil_matvec_f32, float)
CRBE_STENCIL_ENTRY(crbe_stencil_matvec_f64, double)

const char* crbe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
