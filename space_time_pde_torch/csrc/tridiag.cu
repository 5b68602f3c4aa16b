// Batched tridiagonal solve for Hopper (sm_90a): stpde_tridiag_solve, the
// Helmholtz solves of the RB2D Boussinesq data generator
// (space_time_pde_torch/data/rb2_solver.py).
//
// Replaces no Pallas TPU kernel: the JAX package runs this solver in numpy
// on the host (space_time_pde_tpu/data/generator.py::_thomas_batched,
// :80-99, called from _RB2Solver._solve_helmholtz, :143-169). On the card
// the solve is a recurrence down z, one system per Fourier mode in x: as
// PyTorch operators each solve would be ~4 nz dependent launches, so it is
// one kernel.
//
// The systems: for each mode k of nk, rows i = 0 .. nz - 1,
//   lower[i] x[i - 1, k] + diag[i, k] x[i, k] + upper[i, k] x[i + 1, k]
//     = rhs[i, k],
// real coefficients, complex128 right-hand sides, every array but lower
// [nz, nk] row-major (the layout torch.fft.rfft(f, dim=1) returns for
// f [nz, nx]), so neighbouring threads (modes) read neighbouring
// addresses. The sub-diagonal is one [nz] vector for every mode (1 / dz^2
// in the solver's operators but the last row), read by every thread of a
// row at once. The
// coefficients do not depend on the right-hand side, so the elimination
// factors are computed once per operator on the host
// (ops/tridiag.py::factor): c[i] = upper[i] / denom[i] and
// inv[i] = 1 / denom[i], denom[0] = diag[0],
// denom[i] = diag[i] - lower[i] c[i - 1]. A solve is the d sweep and the
// back substitution:
//   d[0] = rhs[0] inv[0],  d[i] = (rhs[i] - lower[i] d[i - 1]) inv[i],
//   x[nz - 1] = d[nz - 1],  x[i] = d[i] - c[i] x[i + 1].
// numpy divides by a complex number of zero imaginary part as a product
// with its reciprocal, so the reciprocal is stored and every step is a
// product: with the round-to-nearest intrinsics (no contraction into
// FMA) the kernel does numpy's arithmetic, operation for operation.
//
// Which right-hand-side rows count as zero (_solve_helmholtz zeroes them
// after its FFT): zero_rows = 1 rows 0 and nz - 1 of every mode
// (Dirichlet), 2 row 0 of mode 0 (Neumann with the kx = 0 mode pinned).
//
// Bound: bytes. A solve reads rhs (16 bytes), c and inv (8 each) and
// writes x (16) for each of nz x nk entries, 48 bytes against 10 float64
// operations, and reads lower's 8 nz bytes: at 128 x 257 (the 512 x 128
// flagship grid) 1.58 MB, 0.47 us at 3.35 TB/s. This first design is latency-bound instead: one
// thread a mode (257 threads, 3 blocks of 128 on a card of 132 SMs)
// walks its column down and back up, each row's update waiting on the
// last. d is written into x on the way down and read back on the way up
// (the thread's own writes, served from L1 / L2). A faster design (a
// block per few modes holding the column in shared memory, or cyclic
// reduction across a warp) is later work.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
tridiag_kernel(const double2* __restrict__ rhs,
               const double* __restrict__ lower,
               const double* __restrict__ c,
               const double* __restrict__ inv,
               double2* __restrict__ x, int nz, int nk, int zero_rows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nk) return;
  const bool zero_first = zero_rows == 1 || (zero_rows == 2 && k == 0);
  const bool zero_last = zero_rows == 1;
  // Down: d[i] = (rhs[i] - lower[i] d[i - 1]) inv[i].
  double2 r = zero_first ? make_double2(0.0, 0.0) : rhs[k];
  double s = inv[k];
  double2 d = make_double2(__dmul_rn(r.x, s), __dmul_rn(r.y, s));
  x[k] = d;
  for (int i = 1; i < nz; ++i) {
    const long long at = static_cast<long long>(i) * nk + k;
    r = (zero_last && i == nz - 1) ? make_double2(0.0, 0.0) : rhs[at];
    const double l = lower[i];
    s = inv[at];
    d.x = __dmul_rn(__dsub_rn(r.x, __dmul_rn(l, d.x)), s);
    d.y = __dmul_rn(__dsub_rn(r.y, __dmul_rn(l, d.y)), s);
    x[at] = d;
  }
  // Up: x[i] = d[i] - c[i] x[i + 1]; d holds x[nz - 1] = d[nz - 1].
  for (int i = nz - 2; i >= 0; --i) {
    const long long at = static_cast<long long>(i) * nk + k;
    const double2 di = x[at];
    const double ci = c[at];
    d.x = __dsub_rn(di.x, __dmul_rn(ci, d.x));
    d.y = __dsub_rn(di.y, __dmul_rn(ci, d.y));
    x[at] = d;
  }
}

}  // namespace

extern "C" {

// rhs, x: complex128 [nz, nk] (interleaved re, im); c, inv: float64
// [nz, nk]; lower: float64 [nz]; all contiguous, on one device.
// Launches on `stream`, returns cudaGetLastError().
int stpde_tridiag_solve(const void* rhs, const void* lower, const void* c,
                        const void* inv, void* x, int nz, int nk,
                        int zero_rows, void* stream) {
  const int threads = 128;
  const int blocks = (nk + threads - 1) / threads;
  tridiag_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(rhs), static_cast<const double*>(lower),
      static_cast<const double*>(c), static_cast<const double*>(inv),
      static_cast<double2*>(x), nz, nk, zero_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
