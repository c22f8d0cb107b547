// Kernel E1: eigen-decomposition of a batch of 4x4 symmetric matrices by
// parallel cyclic Jacobi rotations, for Hopper. A kernel of the port only:
// the reference calls jnp.linalg.eigh, which XLA runs on the device.
// PyTorch's torch.linalg.eigh does the same work on the card but then reads
// its error codes back to the host (_linalg_check_errors): a host wait
// inside every motion step (the virtual-view triangulation of the tracks'
// 4x4 DLT normal matrices) and keyframe step (the post-solve
// triangulation). This kernel reports nothing to the host: a matrix whose
// rotations have not converged after MAX_SWEEPS sweeps keeps its last
// iterate, as a failed eigh leaves NaNs for the caller's gates.
//
// It reads and writes the caller's type (float32 or float64, a template
// argument; the C entry takes the element size) and solves in float64 in
// registers, so a float32 call is this one launch, with no cast kernels
// around it. At float32 the rotations' own rounding moved the float32 blob
// facade's card positions several times further from the CPU's than
// torch.linalg.eigh's float32 solve does; the float64 solve of the float32
// matrix stays within the card test's bounds (PERF.md).
//
// For each 4x4 symmetric matrix A (its lower triangle read, as eigh's
// default UPLO = "L" reads it): eigenvalues L ascending and orthonormal
// eigenvectors V (column k for L[k]) with A V = V diag(L), as
// torch.linalg.eigh returns them, up to the sign of each column (and any
// rotation within a repeated eigenvalue's eigenspace), which eigh leaves
// free as well. The caller uses only sign-free functions of V: the
// homogeneous point q[:3] / q[3] and its cheirality product.
//
// Design: a quad of lanes per matrix, 8 matrices a warp: lane j of the quad
// holds row j of A and row j of V in registers (every index into a row is
// a compile-time constant or a chain of selects, so nothing goes to local
// memory). A sweep is the round-robin (circle) ordering over the 4 indices,
// 3 rounds of 2 disjoint pairs, (r, 3) and ((r + 1) mod 3, (r - 1) mod 3):
// in round r the pairs are j and j ^ (3 - r), ops/eigh.py::_pairs(4, r).
// A round:
//   1. the two lanes of a pair swap their diagonal entries and their entry
//      in the pair's column (one __shfl_xor_sync each; both take a_pq from
//      lane p, the upper triangle) and form the same rotation;
//   2. each lane takes the other pair's (s, tau) from a lane of that pair,
//      and its partner's row, by shuffles;
//   3. rows: its row mixed with its partner's by its pair's rotation;
//   4. columns: its own row's columns (and V's, V <- V J) by both
//      rotations, local; rows before columns, as the CPU model's _rotate;
//   5. its entries of the pair's 2 x 2 block take the new pivot and an
//      exact zero.
// The rotation is E2's (`rotation`, Golub & Van Loan 8.4.2 with Numerical
// Recipes' low-rounding update tau = s / (1 + c)): its square roots and
// divisions from the hardware's approximate reciprocal (square root) and
// two Newton steps, of d and w first scaled to [1, 2) in the larger, so no
// IEEE division or square root lies on the chain. A sweep starts only while
// the sum of squares above the diagonal exceeds eps^2 times the diagonal's
// (eps the float64 unit roundoff; a NaN stops), summed over the quad by
// two shuffles, and at most MAX_SWEEPS run. Each quad keeps its own count:
// the warp loops while any of its quads is live (__any_sync), every lane
// joins every shuffle, and a finished quad's rotations are predicated off.
// Lanes past the last matrix hold a zero matrix (0 sweeps) and store
// nothing. At the end every lane gathers the quad's diagonal and runs the
// same sorting network (ascending; a pair swaps only when strictly out of
// order, so a NaN never moves), swapping its own row's V entries; the quad
// stores its matrix's 16 V entries and 4 eigenvalues as neighbouring lanes
// on neighbouring addresses. ops/eigh.py::jacobi_model at n = 4 is this
// algorithm in float64 PyTorch; the card tests hold the sweeps to it.
//
// Bound: bytes move n^2 in and n + n^2 out per matrix in the caller's type
// (144 bytes in float32); the operations are what a decomposition with
// eigenvectors needs, ~9 n^3 = 576 flops (ops/eigh.py's cost), at the
// card's 34 TFLOP/s of FP64: bytes bound it, ~0.01 us at the motion step's
// 256 matrices. The kernel is far above it: its time is the latency of one
// quad's chain, sweeps x 3 rounds of shuffles and a rotation's ~25
// dependent FP64 operations and four approximate-reciprocal steps, the same
// from 8 matrices to tens of thousands (one warp's quads run side by side).
//
// Plain C interface for ctypes:
//   pvio_sym_eig(A, L, V, sweeps, B, itemsize, stream) on B 4x4 matrices of
//     float32 (itemsize 4) or float64 (8), L and V of the same type,
//     launches on `stream` and returns cudaGetLastError();
//   pvio_sym_eig_max_sweeps() returns MAX_SWEEPS;
//   pvio_sym_eig_abi() returns 2, the form of pvio_sym_eig's arguments
//     above (the earlier one-thread-per-matrix kernel's entry, float64
//     only, had no itemsize and no such export).
//
// THREADS = 32 a block: 32, 64 and 128 ran within 4% of each other at 256
// and 2,816 matrices on the H100, and 32 spreads the motion step's 256
// matrices over 32 SMs (PERF.md).

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int N = 4;
constexpr int MAX_SWEEPS = 30;
constexpr int THREADS = 32;
constexpr unsigned FULL = 0xffffffffu;

// rcp_nr, rsqrt_nr and rotation are copies of their twins in
// sym_eig_block.cu (kernel E2); each library is built from its own source
// alone, so a shared header would not rebuild the other when it changed.

// 1 / x and 1 / sqrt(x) from the hardware's approximations and two Newton
// steps each (a unit or two in the last place), for x well inside the
// normal range
__device__ __forceinline__ double rcp_nr(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  double e = fma(-x, r, 1.0);
  r = fma(r, e, r);
  e = fma(-x, r, 1.0);
  return fma(r, e, r);
}

__device__ __forceinline__ double rsqrt_nr(double x) {
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double h = 0.5 * x;
  r *= fma(-h * r, r, 1.5);
  return r * fma(-h * r, r, 1.5);
}

// The rotation of the pair (p, q) (Golub & Van Loan 8.4.2): t the smaller
// root of t^2 + 2 theta t - 1 = 0, theta = d / w, d = a_qq - a_pp,
// w = 2 a_pq; c = 1 / sqrt(t^2 + 1), s = t c, tau = s / (1 + c). With
// r = sqrt(d^2 + w^2), D = |d| + r and Z = 2 r D = D^2 + w^2, these are
// t = sgn |w| / D, c = D / sqrt(Z), s = sgn |w| / sqrt(Z) and
// tau = sgn |w| / (sqrt(Z) + D), sgn = -1 where theta < 0: two reciprocal
// square roots and two reciprocals, of d and w first scaled by a power of
// two to [1, 2) in the larger (t, c, s and tau depend on d / w only).
// Returns t; s and tau out. a_pq = 0 gives the identity.
__device__ __forceinline__ double rotation(double app, double aqq, double apq, double& s,
                                           double& tau) {
  s = tau = 0.0;
  if (apq == 0.0) return 0.0;
  double d = aqq - app, w = 2.0 * apq;
  const double mx = fmax(fabs(d), fabs(w));
  const long long ex = min(max((__double_as_longlong(mx) >> 52) & 0x7ff, 1LL), 2045LL);
  const double scale = __longlong_as_double((2046 - ex) << 52);  // 2^(1023 - ex)
  const bool neg = (d < 0.0) != (w < 0.0) && d != 0.0;
  d = fabs(d * scale);
  w = fabs(w * scale);
  const double q = fma(d, d, w * w);
  const double r = q * rsqrt_nr(q);
  const double D = d + r, Z = 2.0 * r * D;
  const double rz = rsqrt_nr(Z);
  const double sw = neg ? -w : w;
  s = sw * rz;
  tau = sw * rcp_nr(fma(Z, rz, D));
  return sw * rcp_nr(D);
}

// x[i] of a row in registers, i known only at run time: a chain of selects
// (an indexed access would put the row in local memory)
__device__ __forceinline__ double pick(const double (&x)[N], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

// columns P < Q of one row by a rotation (s, tau): Numerical Recipes' update
template <int P, int Q>
__device__ __forceinline__ void mix_columns(double (&x)[N], double s, double tau) {
  const double g = x[P], h = x[Q];
  x[P] = g - s * (h + g * tau);
  x[Q] = h + s * (g - h * tau);
}

// Round R of a sweep on the quad's matrix: lane j (row j of A in a, of V in
// v) pairs with lane j ^ (3 - R); pair A is (R, 3), pair B the other. Every
// lane joins every shuffle; a lane whose quad is not live changes nothing.
template <int R>
__device__ __forceinline__ void quad_round(double (&a)[N], double (&v)[N], int j, bool live) {
  constexpr int X = N - 1 - R;                               // the partner: j ^ X
  constexpr int O = R == 2 ? 2 : 1;                          // a lane of the other pair: j ^ O
  constexpr int BP = R == 0 ? 1 : 0, BQ = R == 2 ? 1 : 2;    // pair B
  const int partner = j ^ X;
  const bool isp = j < partner;
  // 1. the pair's pivots and a_pq (lane p's, the upper triangle) in both lanes
  const double dg = pick(a, j), off = pick(a, partner);
  const double dg_o = __shfl_xor_sync(FULL, dg, X), off_o = __shfl_xor_sync(FULL, off, X);
  const double app = isp ? dg : dg_o, aqq = isp ? dg_o : dg, apq = isp ? off : off_o;
  double s = 0.0, tau = 0.0, t = 0.0;
  if (live) t = rotation(app, aqq, apq, s, tau);
  // 2. the other pair's rotation and the partner's row
  const double s_o = __shfl_xor_sync(FULL, s, O), tau_o = __shfl_xor_sync(FULL, tau, O);
  double row[N];
#pragma unroll
  for (int k = 0; k < N; ++k) row[k] = __shfl_xor_sync(FULL, a[k], X);
  if (!live) return;
  // 3. rows: lane p takes g - s (h + g tau), lane q h + s (g - h tau), with
  // g row p and h row q
  const double sr = isp ? -s : s, tr = isp ? tau : -tau;
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = a[k] + sr * (row[k] + a[k] * tr);
  // 4. columns of A's row and of V's row by both rotations
  const bool in_a = j == R || j == N - 1;
  const double sa = in_a ? s : s_o, ta = in_a ? tau : tau_o;
  const double sb = in_a ? s_o : s, tb = in_a ? tau_o : tau;
  mix_columns<R, N - 1>(a, sa, ta);
  mix_columns<BP, BQ>(a, sb, tb);
  mix_columns<R, N - 1>(v, sa, ta);
  mix_columns<BP, BQ>(v, sb, tb);
  // 5. the pair's own 2 x 2 block: the new pivot and an exact zero
  const double piv = isp ? app - t * apq : aqq + t * apq;
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = k == j ? piv : k == partner ? 0.0 : a[k];
}

// order eigenpairs I < J by eigenvalue: swap the diagonal entries and this
// row's V entries when d[J] < d[I]
template <int I, int J>
__device__ __forceinline__ void order_pair(double (&d)[N], double (&v)[N]) {
  if (!(d[J] < d[I])) return;
  double t = d[I];
  d[I] = d[J];
  d[J] = t;
  t = v[I];
  v[I] = v[J];
  v[J] = t;
}

__device__ __forceinline__ void store_row(float* dst, const double (&v)[N]) {
  *reinterpret_cast<float4*>(dst) = make_float4((float)v[0], (float)v[1], (float)v[2], (float)v[3]);
}

__device__ __forceinline__ void store_row(double* dst, const double (&v)[N]) {
  reinterpret_cast<double2*>(dst)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(dst)[1] = make_double2(v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sym_eig_kernel(const T* __restrict__ A, T* __restrict__ L, T* __restrict__ V,
               int* __restrict__ sweeps, int B) {
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int b = gt >> 2, j = gt & 3, lane = threadIdx.x & 31;
  const bool mine = b < B;
  double a[N], v[N];
  const T* Ab = A + (size_t)(mine ? b : 0) * N * N;
#pragma unroll
  for (int k = 0; k < N; ++k) {  // row j of the lower triangle's symmetric matrix
    a[k] = mine ? (double)Ab[k <= j ? j * N + k : k * N + j] : 0.0;
    v[k] = k == j ? 1.0 : 0.0;
  }
  const double eps = DBL_EPSILON * 0.5;
  int sweep = 0;
  bool live = true;
#pragma unroll 1
  for (;;) {
    double off = 0.0, diag = pick(a, j);
    diag *= diag;
#pragma unroll
    for (int k = 0; k < N; ++k) off += k > j ? a[k] * a[k] : 0.0;
    off += __shfl_xor_sync(FULL, off, 1);
    off += __shfl_xor_sync(FULL, off, 2);
    diag += __shfl_xor_sync(FULL, diag, 1);
    diag += __shfl_xor_sync(FULL, diag, 2);
    live = live && sweep < MAX_SWEEPS && off > eps * eps * diag;  // NaN: stop
    if (!__any_sync(FULL, live)) break;
    sweep += live;
    quad_round<0>(a, v, j, live);
    quad_round<1>(a, v, j, live);
    quad_round<2>(a, v, j, live);
  }
  // eigenvalues ascending (a sorting network of five pairs) in every lane,
  // each lane's row of V with them
  const double own = pick(a, j);
  double d[N];
#pragma unroll
  for (int k = 0; k < N; ++k) d[k] = __shfl_sync(FULL, own, (lane & ~3) | k);
  order_pair<0, 1>(d, v);
  order_pair<2, 3>(d, v);
  order_pair<0, 2>(d, v);
  order_pair<1, 3>(d, v);
  order_pair<1, 2>(d, v);
  if (!mine) return;
  store_row(V + (size_t)b * N * N + j * N, v);
  L[(size_t)b * N + j] = (T)pick(d, j);
  if (j == 0) sweeps[b] = sweep;
}

template <typename T>
int launch(const void* A, void* L, void* V, void* sweeps, int B, cudaStream_t stream) {
  const long long lanes = (long long)N * B;
  sym_eig_kernel<T><<<(unsigned)((lanes + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(V), static_cast<int*>(sweeps),
      B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pvio_sym_eig_max_sweeps() { return MAX_SWEEPS; }

extern "C" int pvio_sym_eig_abi() { return 2; }

extern "C" int pvio_sym_eig(const void* A, void* L, void* V, void* sweeps, int B, int itemsize,
                            void* stream) {
  if (B <= 0 || B >= (1 << 29)) return (int)cudaErrorInvalidValue;  // 4 B lanes: int indices
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) return launch<float>(A, L, V, sweeps, B, st);
  if (itemsize == 8) return launch<double>(A, L, V, sweeps, B, st);
  return (int)cudaErrorInvalidValue;
}
