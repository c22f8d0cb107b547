// Kernel E1: eigen-decomposition of a batch of 4x4 symmetric matrices by
// cyclic Jacobi rotations, for Hopper. A kernel of the port only: the
// reference calls jnp.linalg.eigh, which XLA runs on the device. PyTorch's
// torch.linalg.eigh does the same work on the card but then reads its error
// codes back to the host (_linalg_check_errors): a host wait inside every
// motion step (the virtual-view triangulation of the tracks' 4x4 DLT normal
// matrices) and keyframe step (the post-solve triangulation). This kernel
// reports nothing to the host: a matrix whose rotations have not converged
// after MAX_SWEEPS sweeps keeps its last iterate, as a failed eigh leaves
// NaNs for the caller's gates.
//
// It works in float64 whatever the caller's type (the wrapper converts a
// float32 stack on the way in and out). At float32 the rotations' own
// rounding moved the float32 blob facade's card positions several times
// further from the CPU's than torch.linalg.eigh's float32 solve does; the
// float64 solve of the float32 matrix stays within the card test's bounds
// (PERF.md).
//
// For each 4x4 symmetric matrix A (its lower triangle read, as eigh's
// default UPLO = "L" reads it): eigenvalues L ascending and orthonormal eigenvectors V (column k for L[k]) with A V = V diag(L), as
// torch.linalg.eigh returns them, up to the sign of each column (and any
// rotation within a repeated eigenvalue's eigenspace), which eigh leaves
// free as well. The caller uses only sign-free functions of V: the
// homogeneous point q[:3] / q[3] and its cheirality product.
//
// Design: one thread per matrix, A and V in registers: n = 4 is fixed at
// compile time and every loop over pairs, rows and columns is unrolled, so
// no index is dynamic (a dynamic index would put A and V in local memory).
// A sweep visits the n(n-1)/2 pairs (p, q) in row order and zeroes a_pq
// with the rotation of Golub & Van Loan (8.4.2): theta = (a_qq - a_pp) /
// (2 a_pq), t = sign(theta) / (|theta| + sqrt(theta^2 + 1)) (t = 1 /
// (2 theta) where theta^2 would overflow), c = 1 / sqrt(t^2 + 1), s = t c,
// applied in Numerical Recipes' low-rounding form (tau = s / (1 + c),
// symmetric updates, the pivots moved by t a_pq). Sweeps stop
// when the off-diagonal sum of squares is at most eps^2 times the diagonal
// sum of squares (eps the type's unit roundoff), or after MAX_SWEEPS.
// The sweep count of each matrix goes to `sweeps`.
//
// Bound: bytes move n^2 in and n + n^2 out per matrix (288 bytes in
// float64); the operations are the sweeps' rotations, ~(12 n + 20) flops
// each, about 400 a sweep, at the card's 34 TFLOP/s of
// FP64. At the motion step's 256 matrices the work is a few microseconds of
// eight warps; a launch sets the time, as for K1.
//
// Plain C interface for ctypes:
//   pvio_sym_eig(A, L, V, sweeps, B, stream) on B float64 4x4 matrices launches
//     on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int N = 4;
constexpr int MAX_SWEEPS = 30;
constexpr int THREADS = 128;

// zero a[p][q] (p < q) with one rotation, applied to A and to V's columns
template <int P, int Q>
__device__ __forceinline__ void rotate(double (&a)[N][N], double (&v)[N][N]) {
  const double apq = a[P][Q];
  if (apq == 0.0) return;
  const double theta = (a[Q][Q] - a[P][P]) / (2.0 * apq);
  double t;
  if (fabs(theta) > 1e150) {
    t = 0.5 / theta;
  } else {
    t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
    if (theta < 0.0) t = -t;
  }
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c, tau = s / (1.0 + c);
  // the rotation in the form that keeps rounding small (Numerical Recipes'
  // jacobi): the pivots move by t a_pq, the other entries of rows / columns
  // p and q by s (h + g tau) and s (g - h tau)
  a[P][P] -= t * apq;
  a[Q][Q] += t * apq;
  a[P][Q] = a[Q][P] = 0.0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k == P || k == Q) continue;
    const double g = a[k][P], h = a[k][Q];
    a[k][P] = a[P][k] = g - s * (h + g * tau);
    a[k][Q] = a[Q][k] = h + s * (g - h * tau);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double g = v[k][P], h = v[k][Q];
    v[k][P] = g - s * (h + g * tau);
    v[k][Q] = h + s * (g - h * tau);
  }
}

// order eigenpairs I < J by eigenvalue: swap the diagonal entries and V's
// columns when d[J] < d[I]
template <int I, int J>
__device__ __forceinline__ void order_pair(double (&d)[N], double (&v)[N][N]) {
  if (!(d[J] < d[I])) return;
  const double t = d[I];
  d[I] = d[J];
  d[J] = t;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double g = v[k][I];
    v[k][I] = v[k][J];
    v[k][J] = g;
  }
}

__global__ void __launch_bounds__(THREADS)
sym_eig_kernel(const double* __restrict__ A, double* __restrict__ L, double* __restrict__ V,
               int* __restrict__ sweeps, int B) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  double a[N][N], v[N][N];
  const double* Ab = A + (size_t)b * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = i >= j ? Ab[i * N + j] : Ab[j * N + i];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  const double eps = DBL_EPSILON * 0.5;
  int sweep = 0;
#pragma unroll 1
  for (; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, diag = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      diag += a[i][i] * a[i][i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) off += a[i][j] * a[i][j];
    }
    if (!(off > eps * eps * diag)) break;  // converged (or NaN: stop)
    // the pairs in row order
    rotate<0, 1>(a, v);
    rotate<0, 2>(a, v);
    rotate<0, 3>(a, v);
    rotate<1, 2>(a, v);
    rotate<1, 3>(a, v);
    rotate<2, 3>(a, v);
  }
  // eigenvalues ascending (a sorting network of five pairs), their vectors
  // with them
  double d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = a[i][i];
  order_pair<0, 1>(d, v);
  order_pair<2, 3>(d, v);
  order_pair<0, 2>(d, v);
  order_pair<1, 3>(d, v);
  order_pair<1, 2>(d, v);
  double* Lb = L + (size_t)b * N;
  double* Vb = V + (size_t)b * N * N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    Lb[k] = d[k];
#pragma unroll
    for (int i = 0; i < N; ++i) Vb[i * N + k] = v[i][k];
  }
  sweeps[b] = sweep;
}

}  // namespace

extern "C" int pvio_sym_eig(const void* A, void* L, void* V, void* sweeps, int B,
                            void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  sym_eig_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<double*>(L), static_cast<double*>(V),
      static_cast<int*>(sweeps), B);
  return (int)cudaGetLastError();
}
