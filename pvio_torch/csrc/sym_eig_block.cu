// Kernel E2: eigen-decomposition of a batch of n x n symmetric matrices
// (5 <= n <= N_MAX) by parallel cyclic Jacobi rotations, one block per
// matrix, for Hopper. A kernel of the port only: the reference's
// marginalization calls jnp.linalg.eigh (pvio_tpu/estimation/
// marginalization.py:41, the 15x15 clamped pseudo-inverse, and :209, the
// (F*15)-square square-root prior), which XLA runs on the device.
// torch.linalg.eigh does the same work on the card but then reads its error
// codes back to the host (_linalg_check_errors): two host waits inside every
// keyframe step that marginalizes. This kernel reports nothing to the host:
// a matrix whose rotations have not converged after MAX_SWEEPS sweeps keeps
// its last iterate.
//
// It works in float64 whatever the caller's type (the wrapper converts a
// float32 stack on the way in and out), as kernel E1 (sym_eig.cu) does.
//
// For each symmetric matrix A (its lower triangle read, as eigh's default
// UPLO = "L" reads it): eigenvalues L ascending and orthonormal eigenvectors
// V (column k for L[k]) with A V = V diag(L), as torch.linalg.eigh returns
// them, up to the sign of each column and the basis inside a repeated
// eigenvalue, which eigh leaves free as well. The marginalization uses only
// S^T S and S^T infovec, which depend on neither.
//
// Design: n is padded to an even m (a zero row and column, never rotated);
// A lives in shared memory (m x (m + 1) doubles: the odd row pitch keeps a
// column walk free of bank conflicts), and so does V^T while both fit
// (m <= 120: n = 15 and 105); for larger m (n = 135: A alone is 148 KB)
// V^T stays in a per-matrix scratch in global memory, which the 50 MB L2
// holds. A build with V^T in the scratch at every n was slower on the main
// path's matrices (time_e2.py: 8% at 15x15, 36% at a random 105x105;
// PERF.md), so both modes stay. Its rows are updated with contiguous
// accesses, so a thread block cluster with V^T in a peer's shared memory
// (distributed shared memory) would shorten only that phase's latency; it
// is left for a redesign.
//
// A sweep is m - 1 rounds of the round-robin (circle) ordering: in round r
// the m / 2 disjoint pairs are (r, m - 1) and ((r + k) mod (m - 1),
// (r - k) mod (m - 1)) for k = 1 .. m/2 - 1, so every pair is visited once a
// sweep. A round has three phases with a barrier after each:
//   1. one thread per pair forms its rotation from a_pp, a_qq, a_pq with
//      E1's formula (Golub & Van Loan 8.4.2; Numerical Recipes' low-rounding
//      update with tau = s / (1 + c)) and the new pivots a_pp - t a_pq,
//      a_qq + t a_pq;
//   2. rows p and q of A and of V^T mix (a warp per pair, a lane per
//      column);
//   3. columns p and q of A mix (a warp per pair, a lane per row); the
//      lanes that land on a pair's own 2 x 2 block write its new pivots
//      and exact zeros.
// A pair whose rotation is the identity (s = 0) skips phases 2 and 3 but
// for its 2 x 2 block.
// The rotations of one round act on disjoint rows and columns, so they
// commute, and the two-sided update equals the rotations applied one by
// one. Sweeps stop when the off-diagonal sum of squares is at most eps^2
// times the diagonal sum of squares (eps the unit roundoff; E1's test), or
// after MAX_SWEEPS. Then each thread ranks one eigenvalue (ascending; NaN
// last; ties by index, so the ranks are a permutation) and writes it and
// its eigenvector to that rank. The sweep count of each matrix goes to
// `sweeps`.
//
// Bound: bytes move n^2 in and n + n^2 out per matrix (at n = 135 in
// float64, 291 KB); the operations are what a decomposition with
// eigenvectors needs, ~9 n^3 flops (ops/eigh.py's cost: 2.2e7 at n = 135),
// at the card's 34 TFLOP/s of FP64: under a microsecond per matrix. Jacobi
// itself does more, ~(12 n + 20) flops for each of the n (n - 1) / 2
// rotations of a sweep (7x the bound's count at n = 135 in 11 sweeps). The
// kernel is far above both: a round's three barriers and one block's
// shared-memory traffic set its time, about sweeps x rounds of dependent
// phases.
//
// Plain C interface for ctypes:
//   pvio_sym_eig_block(A, L, V, scratch, sweeps, B, n, stream) on B
//     float64 n x n matrices launches on `stream` and returns
//     cudaGetLastError(); `scratch` holds B * m * (m + 1) doubles (m = n
//     rounded up to even) when pvio_sym_eig_block_scratch(n) says so, else
//     it may be null;
//   pvio_sym_eig_block_max_n() and pvio_sym_eig_block_max_sweeps() return
//     N_MAX and MAX_SWEEPS.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int N_MAX = 160;
constexpr int MAX_SWEEPS = 30;
constexpr int MAX_THREADS = 512;
constexpr size_t SMEM_LIMIT = 232448;  // the H100's per-block maximum

__host__ __device__ inline int padded(int n) { return n + (n & 1); }

// shared bytes besides the matrices: per pair s, tau and the two pivots
// (doubles) and p, q (ints); the block reduction's 2 x 32 doubles
__host__ __device__ inline size_t extra_bytes(int m) {
  return (size_t)(m / 2) * (4 * sizeof(double) + 2 * sizeof(int)) + 64 * sizeof(double);
}

__host__ inline size_t matrix_bytes(int m) { return (size_t)m * (m + 1) * sizeof(double); }

__host__ inline bool vt_in_shared(int m) {
  return 2 * matrix_bytes(m) + extra_bytes(m) <= SMEM_LIMIT;
}

// NaN-last strict total order of (value, index): a permutation when ranked
__device__ __forceinline__ bool before(double a, int ia, double b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return nb;
  if (na || a == b) return ia < ib;
  return a < b;
}

__global__ void __launch_bounds__(MAX_THREADS)
sym_eig_block_kernel(const double* __restrict__ A, double* __restrict__ L,
                     double* __restrict__ V, double* __restrict__ scratch,
                     int* __restrict__ sweeps, int n, int vt_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = padded(n), ld = m + 1, half = m / 2, b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  double* a = reinterpret_cast<double*>(smem);
  double* ps = a + (size_t)m * ld;   // per pair: s, tau, new a_pp, new a_qq
  double* ptau = ps + half;
  double* pnp = ptau + half;
  double* pnq = pnp + half;
  double* red = pnq + half;          // 2 x 32
  int* pp = reinterpret_cast<int*>(red + 64);
  int* pq = pp + half;
  // V^T: row k is the eigenvector of a[k][k]; generic addressing lets one
  // code path serve shared and global memory
  double* vt = vt_shared ? reinterpret_cast<double*>(pq + half)   // m ints: 8-byte aligned
                         : scratch + (size_t)b * m * ld;

  const double* Ab = A + (size_t)b * n * n;
  for (int i = warp; i < m; i += warps) {
    for (int j = lane; j < m; j += 32) {
      double x = 0.0;
      if (i < n && j < n) x = i >= j ? Ab[i * n + j] : Ab[j * n + i];
      a[i * ld + j] = x;
      vt[i * ld + j] = i == j ? 1.0 : 0.0;
    }
  }
  __syncthreads();

  const double eps = DBL_EPSILON * 0.5;
  int sweep = 0;
#pragma unroll 1
  for (; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int i = warp; i < m; i += warps) {
      for (int j = lane; j < m; j += 32) {
        const double x = a[i * ld + j];
        if (i < j) off += x * x;
        else if (i == j) diag += x * x;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      off += __shfl_xor_sync(0xffffffffu, off, o);
      diag += __shfl_xor_sync(0xffffffffu, diag, o);
    }
    if (lane == 0) {
      red[warp] = off;
      red[32 + warp] = diag;
    }
    __syncthreads();
    off = 0.0;
    diag = 0.0;
    for (int w = 0; w < warps; ++w) {  // the same sum, in the same order, in every thread
      off += red[w];
      diag += red[32 + w];
    }
    __syncthreads();
    if (!(off > eps * eps * diag)) break;  // converged (or NaN: stop)

#pragma unroll 1
    for (int r = 0; r < m - 1; ++r) {
      // 1. the rotations of this round's pairs, one thread each
      for (int k = tid; k < half; k += T) {
        int P = r, Q = m - 1;
        if (k) {
          P = (r + k) % (m - 1);
          Q = (r - k + m - 1) % (m - 1);
        }
        const int p = min(P, Q), q = max(P, Q);
        const double apq = a[p * ld + q], app = a[p * ld + p], aqq = a[q * ld + q];
        double t = 0.0;
        if (apq != 0.0) {
          const double theta = (aqq - app) / (2.0 * apq);
          if (fabs(theta) > 1e150) {
            t = 0.5 / theta;
          } else {
            t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
            if (theta < 0.0) t = -t;
          }
        }
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        pp[k] = p;
        pq[k] = q;
        ps[k] = s;
        ptau[k] = s / (1.0 + c);
        pnp[k] = app - t * apq;
        pnq[k] = aqq + t * apq;
      }
      __syncthreads();
      // 2. rows p and q of A and of V^T: a warp per pair, a lane per column
      for (int k = warp; k < half; k += warps) {
        const int p = pp[k], q = pq[k];
        const double s = ps[k], tau = ptau[k];
        if (s == 0.0) continue;  // the identity
        for (int j = lane; j < m; j += 32) {
          double g = a[p * ld + j], h = a[q * ld + j];
          a[p * ld + j] = g - s * (h + g * tau);
          a[q * ld + j] = h + s * (g - h * tau);
          g = vt[p * ld + j];
          h = vt[q * ld + j];
          vt[p * ld + j] = g - s * (h + g * tau);
          vt[q * ld + j] = h + s * (g - h * tau);
        }
      }
      __syncthreads();
      // 3. columns p and q of A, a warp per pair, a lane per row (the odd
      //    pitch spreads a column over the banks); the pair's own 2 x 2
      //    block takes its new pivots and exact zeros
      for (int k = warp; k < half; k += warps) {
        const int p = pp[k], q = pq[k];
        const double s = ps[k], tau = ptau[k];
        if (s == 0.0) {  // the columns stay; a_pq (zero, or below t's underflow) becomes 0
          if (lane == 0) {
            a[p * ld + p] = pnp[k];
            a[p * ld + q] = a[q * ld + p] = 0.0;
            a[q * ld + q] = pnq[k];
          }
          continue;
        }
        for (int i = lane; i < m; i += 32) {
          if (i == p) {
            a[p * ld + p] = pnp[k];
            a[p * ld + q] = 0.0;
          } else if (i == q) {
            a[q * ld + p] = 0.0;
            a[q * ld + q] = pnq[k];
          } else {
            const double g = a[i * ld + p], h = a[i * ld + q];
            a[i * ld + p] = g - s * (h + g * tau);
            a[i * ld + q] = h + s * (g - h * tau);
          }
        }
      }
      __syncthreads();
    }
  }

  // eigenvalues ascending, each eigenvector with its value
  double* Lb = L + (size_t)b * n;
  double* Vb = V + (size_t)b * n * n;
  for (int i = tid; i < n; i += T) {
    const double d = a[i * ld + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(a[j * ld + j], j, d, i);
    Lb[rank] = d;
    for (int k = 0; k < n; ++k) Vb[k * n + rank] = vt[i * ld + k];
  }
  if (tid == 0) sweeps[b] = sweep;
}

}  // namespace

extern "C" int pvio_sym_eig_block_max_n() { return N_MAX; }

extern "C" int pvio_sym_eig_block_max_sweeps() { return MAX_SWEEPS; }

extern "C" int pvio_sym_eig_block_scratch(int n) {
  return (n >= 1 && n <= N_MAX && !vt_in_shared(padded(n))) ? 1 : 0;
}

extern "C" int pvio_sym_eig_block(const void* A, void* L, void* V, void* scratch, void* sweeps,
                                  int B, int n, void* stream) {
  if (B <= 0 || n < 1 || n > N_MAX) return (int)cudaErrorInvalidValue;
  const int m = padded(n);
  const int vt_shared = vt_in_shared(m) ? 1 : 0;
  if (!vt_shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (vt_shared ? 2 : 1) * matrix_bytes(m) + extra_bytes(m);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sym_eig_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // a warp per pair, at most MAX_THREADS threads
  const int threads = 32 * (m / 2) < MAX_THREADS ? 32 * (m / 2) : MAX_THREADS;
  sym_eig_block_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<double*>(L), static_cast<double*>(V),
      static_cast<double*>(scratch), static_cast<int*>(sweeps), n, vt_shared);
  return (int)cudaGetLastError();
}
