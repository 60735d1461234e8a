// Whole-loop fused CRBE solve with fixed-k BiCGStab, templated on the
// operator: every time step of the solve in ONE cooperative launch.
//
// Shared by kernel B5 (canvas_solver.cu: the per-DOF canvas operator, the
// counterpart of airpollution_tpu/ops/pallas_solver.py::_solver_kernel) and
// B1's BiCGStab variant (uniform_bicgstab.cu: the 15-scalar uniform
// operator, the counterpart of _uniform_solver_kernel with
// method="bicgstab"). The TPU kernels keep every canvas in one core's VMEM
// and loop over steps and iterations inside the kernel. On Hopper no block
// holds the state, so this is a cooperative persistent kernel: the grid is
// no larger than the number of co-resident blocks, every thread owns the
// same canvas cells (all three families of each) for the whole solve, and a
// grid barrier separates each phase that reads what other blocks wrote. Each
// matvec needs its neighbours' fresh values, so the shrinking-square tiles
// of tile_step.cuh do not apply.
//
// One step (the JAX kernels' arithmetic, Jacobi right preconditioning,
// _EPS = 1e-30 substituted for a zero denominator where the JAX kernels
// do). `Op` supplies the system matvec S, the RHS, the masks and the
// inverse diagonal id, per cell from its `Cell` (the operator values of
// one cell) and at a neighbour by offset. Three phases per iteration, each
// ending at a grid barrier, with every pointwise update fused into the
// matvec phase that follows it:
//
//   S  x0 = mask (2 u - u_prev) (or mask u); u_prev = u;
//      r = b - S x0, b = M u (BE) or 2 M u - S u (CN), + load;
//      rhat = r; p = v = 0; partial (rhat, r)                      | sync
//   k times, (rho, alpha, omega) reset to 1 each step:
//   A  rho = sum; beta; p = r + beta (p - omega v); v = S (id p);
//      partial (rhat, v)                                           | sync
//   B  alpha; u += alpha id p; s = r - alpha v; t = S (id s);
//      partials (t, t), (t, s); r = s                              | sync
//   C  omega; u += omega id s; r -= omega t; partial (rhat, r)     | sync
//
// A matvec phase recomputes, at each neighbour it reads, the operand that
// neighbour's owner holds (id p of A from the neighbour's r, p and v; id s
// of B from its r and v; x0 and u of S from its u and u_prev), with the
// same expression on the same inputs, so it is bit-identical to the value
// the owner computes. Barriers: 1 + 3 k per step, 16 at k = 5 in backward
// Euler and Crank-Nicolson alike (the design that stored each update
// before the matvec that reads it took 27 and 28).
//
// Where the vectors live. A thread's cells are fixed for the solve
// (q = first + j stride, the same for every phase), so in register mode
// (P cells per thread: 1, and 2 for the uniform operator in float) each
// keeps its cells' u, r, rhat, p,
// v and t (3 families each) and, for B5, their 15 coefficients and inverse
// diagonal, read once per solve, in registers. Only what a neighbour reads goes to device
// memory (and stays in the 50 MB L2): r (written in S and C), p and v
// (written in A, two buffers each: a phase writes the copy its neighbours
// are not reading), u (at the end of each step) and u_prev (two buffers).
// Beyond the register capacity (ops/fused_solver.bicgstab_cells), the same
// kernel runs in global mode (P = 0): each phase loads its cells' vectors
// from 6 more canvases and stores what it changed.
//
// The dot products must come out bit-identical in every block, or the
// blocks take different steps and the tiles drift apart. Each thread sums
// its own cells in a fixed order, each block reduces its threads in a fixed
// tree and writes one partial to a global buffer; after the barrier every
// block adds all partials in the same fixed order. No atomics: their order
// changes from run to run. The sums and the scalar recurrence (rho, alpha,
// omega, beta) are carried in double for float data too, as in the plain
// versions (ops/fused_solver._bicgstab_iterations), so that a kernel and
// its plain version differ only by the rounding of the vector updates, not
// by the order of their sums. With the grid and cell ownership of the
// design before (one cell per thread at 257^2), the sums come in the same
// order and the output is bitwise that design's. (A fixed-k BiCGStab
// iterate keeps iterating at rounding level, and in float some
// configurations amplify any rounding difference: chip_smoke.py's BiCGStab
// phases measure and print it.)
//
// The grid barrier: one release-add per block on a counter and a spin on
// an acquire load of it (1.03 us empty on 130 blocks of an H100, against
// 1.12 for cooperative groups' grid sync: scripts/torch_port_ab.py
// --sweep).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace crbe {

constexpr int kMaxGrid = 2048;  // partial-sum slots per reduction

// The own vectors of global mode, in this order after `own`.
constexpr int kOwnU = 0, kOwnR = 1, kOwnRh = 2, kOwnP = 3, kOwnV = 4,
              kOwnT = 5;

template <typename T>
struct SolverIO {
  T* u;         // (3, n, n) state, u0 on entry, the final state on exit
  T* up[2];     // u_prev on entry (up[0]) and its second buffer, or nullptr
  T* r;         // the residual neighbours read
  T* p[2];      // the search direction, two buffers
  T* v[2];      // S id p, two buffers
  T* own;       // global mode: (6, 3, n, n) own u, r, rhat, p, v, t
  const T* load;       // step i's load at load + i * load_stride, or nullptr
  size_t load_stride;  // 0: one plane for every step
  double* part;        // (4, kMaxGrid): rho, (rhat, v), (t, t), (t, s)
  unsigned* bar;       // the grid barrier's counter, 0 at launch
};

__device__ __forceinline__ double guard(double a) {
  return a == 0.0 ? 1e-30 : a;
}

// Fixed-order block sums of K values per thread, written by thread 0 to
// dst[k][blockIdx.x] (stride kMaxGrid): each warp's tree, then warp 0's
// tree over the warps. The caller's grid barrier orders the next use of
// `red` (32 K values).
template <int NT, int K>
__device__ __forceinline__ void block_partials(const double (&v)[K],
                                               double* red, double* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x[k] += __shfl_down_sync(0xffffffffu, x[k], o);
    }
    if (lane == 0) red[32 * k + warp] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = lane < NT / 32 ? red[32 * k + lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        x[k] += __shfl_down_sync(0xffffffffu, x[k], o);
      }
      if (lane == 0) dst[k * kMaxGrid + blockIdx.x] = x[k];
    }
  }
}

// The sums of the G partials of K reductions (part + k kMaxGrid), each in
// one fixed order, identical in every block: warp 0's lanes add the
// partials lane, lane + 32, ... (their loads issued first), then a tree
// over the lanes, and lane 0's sums reach every thread through `tot` (K
// values in shared memory; the caller's grid barrier orders its next
// use).
template <int K>
__device__ __forceinline__ void block_totals(const double* part, int G,
                                             double* tot, double (&out)[K]) {
  constexpr int kBatch = 5;  // loads in flight per lane and reduction
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = 0.0;
    for (int base = lane; base < G; base += 32 * kBatch) {
      double x[K][kBatch];
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int i = base + 32 * m;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          x[k][m] = i < G ? __ldcg(part + k * kMaxGrid + i) : 0.0;
        }
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        if (base + 32 * m < G) {
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] += x[k][m];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
      }
      if (lane == 0) tot[k] = v[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = tot[k];
}

// The grid barrier (see the top of this file).
struct GridBarrier {
  unsigned* count;
  unsigned target;

  __device__ __forceinline__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      target += gridDim.x;
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :
                   : "l"(count)
                   : "memory");
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen)
                     : "l"(count)
                     : "memory");
      } while (static_cast<int>(seen - target) < 0);
    }
    __syncthreads();
  }
};

// The nine values a stencil row of cell (i, j) reads: its own three and
// six of its neighbours'; cells outside the canvas are zero.
template <typename T>
struct Neighbours {
  T h0, hl, hd, v0, vr, vu, d0, dl, du;
};

// The six neighbour values besides a cell's own three, as slots: H at
// (i, j-1) and (i+1, j), V at (i, j+1) and (i-1, j), D at (i, j-1) and
// (i-1, j) (Neighbours' hl, hd, vr, vu, dl, du), with their offsets and a
// bit per slot on the canvas. Slot s holds family s / 2.

struct Slots {
  size_t q[6];
  int i[6], j[6];
  unsigned on;

  __device__ __forceinline__ Slots(int n, int ci, int cj, size_t cq) {
    const bool up = ci >= 1, down = ci + 1 < n, left = cj >= 1,
               right = cj + 1 < n;
    const int di[6] = {0, 1, 0, -1, 0, -1};
    const int dj[6] = {-1, 0, 1, 0, -1, 0};
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      i[s] = ci + di[s];
      j[s] = cj + dj[s];
      q[s] = cq + static_cast<ptrdiff_t>(di[s]) * n + dj[s];
    }
    on = (left ? 1u : 0u) | (down ? 2u : 0u) | (right ? 4u : 0u) |
         (up ? 8u : 0u) | (left ? 16u : 0u) | (up ? 32u : 0u);
  }
  __device__ __forceinline__ bool at(int s) const { return (on >> s) & 1u; }
};

template <typename T>
__device__ __forceinline__ Neighbours<T> assemble(const T o[3],
                                                  const T x[6]) {
  return Neighbours<T>{o[0], x[0], x[1], o[1], x[2], x[3], o[2], x[4], x[5]};
}

// The neighbours of a cell whose slot values are val(s, family, offset, i,
// j) on the canvas and 0 off it.
template <typename T, typename F>
__device__ __forceinline__ Neighbours<T> gather(const Slots& sl,
                                                const T o[3], F&& val) {
  T x[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    x[s] = sl.at(s) ? val((s >> 1), sl.q[s], sl.i[s], sl.j[s]) : T(0);
  }
  return assemble(o, x);
}

// One cell's vectors (3 families each).
template <typename T>
struct Own {
  T u[3], r[3], rh[3], p[3], v[3], t[3];
};

// A matvec phase's neighbour operands, loaded before the phase's scalars
// are known: the residual, search direction and v (phase A; B leaves p
// out), and the inverse diagonal, at each slot.
template <typename T>
struct Fetched {
  T r[6], p[6], v[6], id[6];
};

// P cells per thread in registers (P > 0), or global mode (P = 0).
template <int NT, int P, typename T, class Op>
__global__ void __launch_bounds__(NT, 1)
    bicgstab_kernel(Op op_arg, SolverIO<T> io, int n, int n_steps,
                    int n_iters, int use_ka) {
  __shared__ double red[64];
  __shared__ double tot[2];
  Op op = op_arg;
  op.load();  // an operator held in registers reads its values once
  constexpr int kCells = P > 0 ? P : 1;
  GridBarrier bar{io.bar, 0};
  const size_t nn = static_cast<size_t>(n) * n;
  const int G = gridDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  const size_t stride = static_cast<size_t>(G) * NT;
  double* part_rho = io.part;
  double* part_den = io.part + kMaxGrid;
  double* part_tt = io.part + 2 * kMaxGrid;  // then (t, s) at + kMaxGrid
  const bool ext = io.up[0] != nullptr;
  auto ld = [](const T* p) { return __ldcg(p); };

  // Register mode: the owned cells' vectors and operator values.
  Own<T> own[kCells];
  typename Op::Cell oc[kCells];
  if constexpr (P > 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const size_t q = first + j * stride;
      if (q < nn) {
        const int i = static_cast<int>(q / n);
        oc[j] = op.cell(q, i,
                        static_cast<int>(q - static_cast<size_t>(i) * n));
      }
    }
  }

  // Calls f(j, own, cell, q, i, jc) for each canvas cell this thread owns
  // (j its slot in register mode, 0 in global mode). In global mode the
  // vectors named by the high byte of in_out are loaded first and those
  // named by its low byte stored after (bit kOwn* of each).
  auto cells = [&](auto in_out, auto&& f) {
    constexpr unsigned kIn = decltype(in_out)::value >> 8;
    constexpr unsigned kOut = decltype(in_out)::value & 0xffu;
    if constexpr (P > 0) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const size_t q = first + j * stride;
        if (q < nn) {
          const int i = static_cast<int>(q / n);
          f(j, own[j], oc[j], q, i,
            static_cast<int>(q - static_cast<size_t>(i) * n));
        }
      }
    } else {
      for (size_t q = first; q < nn; q += stride) {
        const int i = static_cast<int>(q / n);
        const int jc = static_cast<int>(q - static_cast<size_t>(i) * n);
        Own<T> o;
        T* vec[6] = {o.u, o.r, o.rh, o.p, o.v, o.t};
#pragma unroll
        for (int b = 0; b < 6; ++b) {
          if (kIn & (1u << b)) {
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              vec[b][f] = ld(io.own + (3 * b + f) * nn + q);
            }
          }
        }
        const typename Op::Cell c = op.cell(q, i, jc);
        f(0, o, c, q, i, jc);
#pragma unroll
        for (int b = 0; b < 6; ++b) {
          if (kOut & (1u << b)) {
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              io.own[(3 * b + f) * nn + q] = vec[b][f];
            }
          }
        }
      }
    }
  };
  // A matvec phase: fetch(q, i, j, Fetched&) loads a cell's neighbour
  // operands, scalars() then sums the reductions the phase needs, and
  // compute(j, own, cell, q, i, jc, fetched) does the rest. Register mode
  // fetches for all its cells first, so that the loads are in flight while
  // the partials are summed; global mode fetches each cell's right before
  // its compute.
  auto matvec_phase = [&](auto in_out, auto&& fetch, auto&& scalars,
                          auto&& compute) {
    if constexpr (P > 0) {
      Fetched<T> fe[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const size_t q = first + j * stride;
        if (q < nn) {
          const int i = static_cast<int>(q / n);
          fetch(q, i, static_cast<int>(q - static_cast<size_t>(i) * n),
                fe[j]);
        }
      }
      scalars();
      cells(in_out, [&](int j, Own<T>& o, const typename Op::Cell& c,
                        size_t q, int i, int jc) {
        compute(o, c, q, i, jc, fe[j]);
      });
    } else {
      scalars();
      cells(in_out, [&](int, Own<T>& o, const typename Op::Cell& c,
                        size_t q, int i, int jc) {
        Fetched<T> fe;
        fetch(q, i, jc, fe);
        compute(o, c, q, i, jc, fe);
      });
    }
  };
  constexpr unsigned U = 1u << kOwnU, R = 1u << kOwnR, RH = 1u << kOwnRh,
                     PP = 1u << kOwnP, V = 1u << kOwnV, TT = 1u << kOwnT;

  for (int step = 0; step < n_steps; ++step) {
    // S: the step's right-hand side, warm start and initial residual.
    const T* up_in = ext ? io.up[step & 1] : nullptr;
    T* up_out = ext ? io.up[(step + 1) & 1] : nullptr;
    const T* load =
        io.load == nullptr ? nullptr : io.load + step * io.load_stride;
    double acc[2] = {0.0, 0.0};
    cells(std::integral_constant<unsigned, U | R | RH | PP | V>{},
          [&](int, Own<T>& o, const typename Op::Cell& c, size_t q, int i,
              int j) {
            const Slots sl(n, i, j, q);
            T u[3], x0[3];
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              u[f] = ld(io.u + f * nn + q);
              const T mk = op.mask(c, f, q, i, j);
              if (ext) {
                const T guess = T(2) * u[f] - ld(up_in + f * nn + q);
                up_out[f * nn + q] = u[f];
                x0[f] = guess * mk;
              } else {
                x0[f] = u[f] * mk;
              }
            }
            T b[3];
            if (use_ka) {
              T y[3];
              op.apply(c, gather(sl, u, [&](int f, size_t qn, int, int) {
                         return ld(io.u + f * nn + qn);
                       }),
                       i, j, y);
#pragma unroll
              for (int f = 0; f < 3; ++f) {
                b[f] = op.cn_rhs(c, f, q, u[f], y[f]);
              }
            } else {
#pragma unroll
              for (int f = 0; f < 3; ++f) b[f] = op.be_rhs(c, f, q, u[f]);
            }
            T y[3];
            op.apply(c, gather(sl, x0, [&](int f, size_t qn, int in, int jn) {
                       const T un = ld(io.u + f * nn + qn);
                       const T mk = op.mask_at(f, qn, in, jn);
                       if (ext) return (T(2) * un - ld(up_in + f * nn + qn)) * mk;
                       return un * mk;
                     }),
                     i, j, y);
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              const size_t of = f * nn + q;
              T rv = b[f];
              if (load != nullptr) rv += __ldg(load + of);
              rv = rv - y[f];
              o.u[f] = x0[f];
              o.r[f] = rv;
              o.rh[f] = rv;
              o.p[f] = T(0);
              o.v[f] = T(0);
              io.r[of] = rv;
              io.p[0][of] = T(0);
              io.v[0][of] = T(0);
              acc[0] += static_cast<double>(rv * rv);
            }
          });
    block_partials<NT, 1>(reinterpret_cast<const double(&)[1]>(acc), red,
                          part_rho);
    bar.sync();

    double rho_old = 1.0, alpha = 1.0, omega = 1.0;
    for (int it = 0; it < n_iters; ++it) {
      const T* p_in = io.p[it & 1];
      const T* v_in = io.v[it & 1];
      T* p_out = io.p[(it + 1) & 1];
      T* v_out = io.v[(it + 1) & 1];
      // A: p = r + beta (p - omega v); v = S (id p).
      double rho = 0.0;
      T beta = T(0), omega_t = T(0);
      acc[0] = 0.0;
      matvec_phase(
          std::integral_constant<unsigned, ((R | RH | PP | V) << 8) |
                                               (PP | V)>{},
          [&](size_t q, int i, int j, Fetched<T>& fe) {
            const Slots sl(n, i, j, q);
#pragma unroll
            for (int s = 0; s < 6; ++s) {
              const size_t of = (s >> 1) * nn + sl.q[s];
              const bool on = sl.at(s);
              fe.r[s] = on ? ld(io.r + of) : T(0);
              fe.p[s] = on ? ld(p_in + of) : T(0);
              fe.v[s] = on ? ld(v_in + of) : T(0);
              fe.id[s] = on ? op.idiag_at(s >> 1, sl.q[s]) : T(0);
            }
          },
          [&] {
            double sum[1];
            block_totals<1>(part_rho, G, tot, sum);
            rho = sum[0];
            beta = static_cast<T>((rho / guard(rho_old)) *
                                  (alpha / guard(omega)));
            omega_t = static_cast<T>(omega);
          },
          [&](Own<T>& o, const typename Op::Cell& c, size_t q, int i, int j,
              const Fetched<T>& fe) {
            const Slots sl(n, i, j, q);
            T w[3], x[6];
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              o.p[f] = o.r[f] + beta * (o.p[f] - omega_t * o.v[f]);
              w[f] = op.idiag(c, f) * o.p[f];
            }
#pragma unroll
            for (int s = 0; s < 6; ++s) {
              const T pn = fe.r[s] + beta * (fe.p[s] - omega_t * fe.v[s]);
              x[s] = sl.at(s) ? fe.id[s] * pn : T(0);
            }
            T y[3];
            op.apply(c, assemble(w, x), i, j, y);
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              const size_t of = f * nn + q;
              o.v[f] = y[f];
              p_out[of] = o.p[f];
              v_out[of] = y[f];
              acc[0] += static_cast<double>(o.rh[f] * y[f]);
            }
          });
      block_partials<NT, 1>(reinterpret_cast<const double(&)[1]>(acc), red,
                            part_den);
      bar.sync();

      // B: u += alpha id p; s = r - alpha v; t = S (id s).
      T alpha_t = T(0);
      acc[0] = acc[1] = 0.0;
      matvec_phase(
          std::integral_constant<unsigned, ((U | R | PP | V) << 8) |
                                               (U | R | TT)>{},
          [&](size_t q, int i, int j, Fetched<T>& fe) {
            const Slots sl(n, i, j, q);
#pragma unroll
            for (int s = 0; s < 6; ++s) {
              const size_t of = (s >> 1) * nn + sl.q[s];
              const bool on = sl.at(s);
              fe.r[s] = on ? ld(io.r + of) : T(0);
              fe.v[s] = on ? ld(v_out + of) : T(0);
              fe.id[s] = on ? op.idiag_at(s >> 1, sl.q[s]) : T(0);
            }
          },
          [&] {
            double sum[1];
            block_totals<1>(part_den, G, tot, sum);
            alpha = rho / guard(sum[0]);
            alpha_t = static_cast<T>(alpha);
          },
          [&](Own<T>& o, const typename Op::Cell& c, size_t q, int i, int j,
              const Fetched<T>& fe) {
            const Slots sl(n, i, j, q);
            T w[3], x[6];
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              o.u[f] = o.u[f] + alpha_t * (op.idiag(c, f) * o.p[f]);
              o.r[f] = o.r[f] - alpha_t * o.v[f];
              w[f] = op.idiag(c, f) * o.r[f];
            }
#pragma unroll
            for (int s = 0; s < 6; ++s) {
              const T sn = fe.r[s] - alpha_t * fe.v[s];
              x[s] = sl.at(s) ? fe.id[s] * sn : T(0);
            }
            T y[3];
            op.apply(c, assemble(w, x), i, j, y);
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              o.t[f] = y[f];
              acc[0] += static_cast<double>(y[f] * y[f]);
              acc[1] += static_cast<double>(y[f] * o.r[f]);
            }
          });
      block_partials<NT, 2>(acc, red, part_tt);
      bar.sync();

      // C: u += omega id s; r = s - omega t.
      {
        double sum[2];
        block_totals<2>(part_tt, G, tot, sum);
        omega = sum[1] / guard(sum[0]);
      }
      const T omega_new = static_cast<T>(omega);
      const bool last = it + 1 == n_iters;
      acc[0] = 0.0;
      cells(std::integral_constant<unsigned, ((U | R | RH | TT) << 8) |
                                                 (U | R)>{},
            [&](int, Own<T>& o, const typename Op::Cell& c, size_t q, int,
                int) {
#pragma unroll
              for (int f = 0; f < 3; ++f) {
                const size_t of = f * nn + q;
                o.u[f] = o.u[f] + omega_new * (op.idiag(c, f) * o.r[f]);
                o.r[f] = o.r[f] - omega_new * o.t[f];
                io.r[of] = o.r[f];
                if (last) io.u[of] = o.u[f];
                acc[0] += static_cast<double>(o.rh[f] * o.r[f]);
              }
            });
      block_partials<NT, 1>(reinterpret_cast<const double(&)[1]>(acc), red,
                            part_rho);
      bar.sync();
      rho_old = rho;
    }
  }
  // The last u_prev into the caller's buffer (each thread its own cells).
  if (ext && (n_steps & 1)) {
    for (size_t q = first; q < nn; q += stride) {
#pragma unroll
      for (int f = 0; f < 3; ++f) io.up[0][f * nn + q] = io.up[1][f * nn + q];
    }
  }
}

// The grid of a solve: register mode (cells per thread P > 0) covers the
// canvas with P cells per thread; global mode takes every co-resident
// block (at most one per 512 threads of cells and kMaxGrid).
template <int NT, typename K>
inline int solve_grid(K kernel, int n, int cells, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long total = static_cast<long>(n) * n;
  const long most = static_cast<long>(per_sm) * sms;
  long g = (total + static_cast<long>(NT) * (cells > 0 ? cells : 1) - 1) /
           (static_cast<long>(NT) * (cells > 0 ? cells : 1));
  if (cells > 0 && g > most) return cudaErrorCooperativeLaunchTooLarge;
  if (g > most) g = most;
  if (g > kMaxGrid) g = kMaxGrid;
  *grid = static_cast<int>(g);
  return cudaSuccess;
}

template <int NT, int P, typename T, class Op>
int launch_bicgstab_nt(const Op& op, SolverIO<T> io, int n, int n_steps,
                       int n_iters, int use_ka, void* stream,
                       int* grid_out) {
  auto kernel = bicgstab_kernel<NT, P, T, Op>;
  int grid = 0;
  int err = solve_grid<NT>(kernel, n, P, &grid);
  if (err != cudaSuccess) return err;
  *grid_out = grid;
  cudaError_t e = cudaMemsetAsync(io.bar, 0, sizeof(unsigned),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  Op op_arg = op;
  void* args[] = {&op_arg, &io, &n, &n_steps, &n_iters, &use_ka};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                  dim3(NT), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The block size of both BiCGStab kernels (ops/fused_solver.CANVAS_THREADS).
constexpr int kBicgstabThreads = 512;

// The solve's buffers: `work` holds the Krylov canvases of 3 n^2 values
// each, r, p (2), v (2) and u_prev's second buffer, then in global mode
// (cells = 0) the 6 own canvases; `partials` 4 kMaxGrid sums and the
// barrier's counter. `cells`: the plan's cells per thread (1, 2; 0 global
// mode; ops/fused_solver.bicgstab_cells).
template <typename T, class Op>
int launch_bicgstab(const Op& op, T* u, T* up, T* work, double* partials,
                    const T* load, int load_stride, int n, int n_steps,
                    int n_iters, int use_ka, int cells, void* stream,
                    int* grid_out) {
  if (n < 2 || n_iters < 1 || load_stride < 0) return cudaErrorInvalidValue;
  const size_t plane = 3 * static_cast<size_t>(n) * n;
  SolverIO<T> io;
  io.u = u;
  io.up[0] = up;
  io.up[1] = up == nullptr ? nullptr : work + 5 * plane;
  io.r = work;
  io.p[0] = work + plane;
  io.p[1] = work + 2 * plane;
  io.v[0] = work + 3 * plane;
  io.v[1] = work + 4 * plane;
  io.own = cells == 0 ? work + 6 * plane : nullptr;
  io.load = load;
  io.load_stride = static_cast<size_t>(load_stride);
  io.part = partials;
  io.bar = reinterpret_cast<unsigned*>(partials + 4 * kMaxGrid);
  constexpr int NT = kBicgstabThreads;
  switch (cells) {
    case 0:
      return launch_bicgstab_nt<NT, 0>(op, io, n, n_steps, n_iters, use_ka,
                                       stream, grid_out);
    case 1:
      return launch_bicgstab_nt<NT, 1>(op, io, n, n_steps, n_iters, use_ka,
                                       stream, grid_out);
    case 2:
      if constexpr (Op::kMaxCells >= 2) {
        return launch_bicgstab_nt<NT, 2>(op, io, n, n_steps, n_iters, use_ka,
                                         stream, grid_out);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace crbe
