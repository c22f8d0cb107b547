// Kernel E2: eigen-decomposition of a batch of n x n symmetric matrices
// (5 <= n <= N_MAX) by Jacobi rotations, for Hopper. A kernel of the port
// only: the reference's marginalization calls jnp.linalg.eigh (pvio_tpu/
// estimation/marginalization.py:41, the 15x15 clamped pseudo-inverse, and
// :209, the (F*15)-square square-root prior), which XLA runs on the device.
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
// S^T S and S^T infovec, which depend on neither. ops/eigh.py::jacobi_model
// is this algorithm in float64 PyTorch; the CPU tests hold it to eigh.
//
// The rotations. A round-robin (circle) sweep over m indices (m even) is
// m - 1 rounds; in round r the m / 2 disjoint pairs are (r, m - 1) and
// ((r + k) mod (m - 1), (r - k) mod (m - 1)) for k = 1 .. m/2 - 1. A pair's
// rotation is E1's (Golub & Van Loan 8.4.2; Numerical Recipes' low-rounding
// update with tau = s / (1 + c)), its square roots and divisions formed
// from the hardware's approximate reciprocal (square root) and two Newton
// steps (`rotation`). The rotations of a round act on disjoint rows and
// columns, so they commute; each pair's own 2 x 2 block takes its new
// pivots and exact zeros, every other 2 x 2 block both sides of the round
// at once (rows by one rotation, then columns by the other; the block and
// its transpose from one computation). A sweep starts only while the sum of
// squares above the diagonal exceeds eps^2 times the diagonal's (eps the
// unit roundoff; E1's test), and at most MAX_SWEEPS run; `sweeps` receives
// the count.
//
// Two forms, chosen by n at launch:
//
// (a) Small form, n <= WARP_N (the 15x15 victim block): one warp per
// matrix, SMALL_WARPS matrices per block, n padded to 16 (or 32) with zero
// rows and columns. S and V^T (pitch m + 1) live in the warp's slice of
// shared memory. A round: every lane forms a rotation (lanes k < 8 pair k's,
// written to S and to a double-buffered table) while it rotates its share of
// V^T's rows by the last round's table, one branch-free stream;
// __syncwarp(); every lane updates its off-diagonal 2 x 2 block of S, all
// its loads before its stores; __syncwarp(). No block barrier: a round is
// one warp's chain, where the earlier one-block-per-matrix kernel paid three
// block barriers (~1.4 us a round).
//
// (b) Blocked form, WARP_N < n <= N_MAX (the prior, n = F * 15): A is padded
// to nb tiles of TILE = 15 rows (one frame's; nb even), and a sweep is
// nb - 1 rounds of the round-robin ordering over tiles (9 rounds of 5 tile
// pairs at F = 9, where the scalar ordering took 135 rounds of 68 pairs).
// One thread block cluster of nb / 2 CTAs of 256 threads per matrix (5 at
// F = 9, 8 at n = 240, the portable maximum). CTA k holds tile pair k's two
// block rows of A in its shared memory, and a fixed block of rv =
// ceil(n / (nb/2)) rows of V; nothing lives in L2. A round:
//   1. the pair's 30 x 30 diagonal block (read from its lower triangle) goes
//      through one inner sweep by the CTA's 8 warps (`jacobi_sweep_cta`:
//      warp 0 forms the rotations, warps 0-3 update the 2 x 2 blocks, warps
//      4-7 accumulate Q^T one step behind, on named barriers), the full
//      round-robin sweep in a sweep's first round and only the 15 rounds of
//      the pairs across the two tiles in the others, so that every pair of
//      indices turns once a sweep (the pairs inside a tile would otherwise
//      turn in every round: 1,043 inner rounds in 7 sweeps against 1,566
//      in 6 on a marginalization-like matrix at n = 135, PERF.md);
//      the block goes back into A's rows and Q^T_c
//      (32 x 32, identity past 30) into every CTA's copy, 16-byte stores into
//      the peers' shared memory, then a cluster barrier arrives;
//   2. rows: A[R, j] <- Q^T_c A[R, j] for A's columns outside the pair, on
//      the FP64 tensor cores (mma.m8n8k4: a warp per 8 columns, Q^T_c's
//      fragments in registers);
//   3. the barrier waits (every Q^T has arrived); columns: A[R, P_d] <-
//      A[R, P_d] Q_d for every other pair d, and V[rows, P_d] <- V[rows, P_d]
//      Q_d for every pair d (V = V Q, so V's rows never move), a warp per
//      (matrix, block, 16 rows), also on the tensor cores;
//   4. A's rows move to the CTAs that hold their tiles in the next round
//      (the circle ordering moves every tile but the fixed one): straight
//      into the peer's second buffer and one cluster barrier where two
//      buffers fit (n <= 210), else through registers between two.
// So A <- Q^T A Q with Q block-diagonal after the pairing's permutation, the
// diagonal blocks taking the inner solve's result. At the end of a sweep
// each CTA adds its rows' share of the stopping test (entries above the
// diagonal by global index) and writes it to every CTA, which all sum the
// shares in the same order and so stop together. At the end the diagonal
// goes to every CTA, each ranks every eigenvalue (ascending; NaN last; ties
// by index, so the ranks are a permutation) and writes its rows of V. No
// atomics: a matrix of a stack gives what its single launch gives, bit for
// bit. A stack of B matrices is B clusters at one CTA per SM (~177 KB of
// shared memory at n = 135): 11 priors take 55 of the 132 SMs; past what the
// GPCs hold at once (pvio_sym_eig_block_max_clusters: 22 at n = 135, 15 at
// n = 240 on an H100) the rest wait for a second wave.
//
// Bound: bytes move n^2 in and n + n^2 out per matrix (at n = 135 in
// float64, 291 KB); the operations are what a decomposition with
// eigenvectors needs, ~9 n^3 flops (ops/eigh.py's cost: 2.2e7 at n = 135),
// at the card's 67 TFLOP/s of FP64 on the tensor cores, where the blocked
// form mixes rows and columns: under a microsecond per matrix. The
// kernel is far above it: its time is sweeps x rounds of dependent steps,
// each a chain of shared-memory loads, a rotation's ~25 dependent FP64
// operations and three approximate-reciprocal steps, and barriers (two
// named barriers a warp round, two or three cluster barriers a round).
// time_e2.py --phases prints each phase's cycles per round.
//
// Plain C interface for ctypes:
//   pvio_sym_eig_block(A, L, V, scratch, sweeps, B, n, stream) on B
//     float64 n x n matrices launches on `stream` and returns the launch's
//     CUDA error; `scratch` is unused (null is fine), kept so that time_e2.py
//     can call builds of the earlier one-block design through one entry;
//   pvio_sym_eig_block_max_n(), pvio_sym_eig_block_max_sweeps(),
//     pvio_sym_eig_block_warp_n() and pvio_sym_eig_block_tile() return
//     N_MAX, MAX_SWEEPS, WARP_N and TILE (ops/eigh.py checks them against
//     its own, which its CPU model of this kernel uses);
//   pvio_sym_eig_block_max_clusters(n) returns how many matrices of size n
//     the card runs at once (cudaOccupancyMaxActiveClusters; 0 in the
//     small form, whose blocks hold SMALL_WARPS matrices each).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace cg = cooperative_groups;

namespace {

constexpr int N_MAX = 240;
constexpr int MAX_SWEEPS = 30;
constexpr int WARP_N = 32;                  // the small form's largest n
constexpr int SMALL_WARPS = 4;              // matrices per block in the small form
constexpr int TILE = 15;                    // the blocked form's tile: one frame's rows
constexpr int SUB = 2 * TILE;               // a tile pair's rows
constexpr int SUB_LD = SUB + 1;             // the inner solve's pitch (odd)
constexpr int QP = 32;                      // a Q^T, padded to 32 x 32 (the identity past SUB)
constexpr int QLD = 36;                     // its pitch: 4 mod 16 doubles, as the rows' (row_pitch)
constexpr int CLUSTER_MAX = 8;              // the portable cluster size: nb <= 16
constexpr int THREADS = 256;                // the blocked form's CTA
constexpr int WARPS = THREADS / 32;
constexpr int MOVE = (SUB * ((N_MAX + 3) / 4) + THREADS - 1) / THREADS;  // row segments a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 232448;       // the H100's shared memory per block

static_assert(N_MAX <= 2 * CLUSTER_MAX * TILE, "N_MAX needs more CTAs than a cluster holds");
static_assert(N_MAX <= THREADS && THREADS == 256, "a thread per column; the inner solve's 8 warps");

struct Rot {  // one round's rotations: (s, tau) and p | q << 8 per pair
  double2 st[WARP_N / 2];
  int pq[WARP_N / 2];
};

// Phase counters of thread 0 of each CTA of the first matrix (e2_prof[16 c
// + i], CTA c, phase i; the small form: the first matrix's lane 0),
// compiled in only with -DPVIO_E2_PROFILE (time_e2.py --phases): SM cycles
// per phase, kept in registers and added to e2_prof where a routine ends.
#ifdef PVIO_E2_PROFILE
__device__ unsigned long long e2_prof[16 * CLUSTER_MAX];
#define PROF_START(on)                             \
  long long prof_t = clock64(), prof_acc[16] = {}; \
  const int prof_at = (on) ? 16 * (int)blockIdx.x : -1
#define PROF(i)                                    \
  do {                                             \
    const long long prof_now = clock64();          \
    prof_acc[i] += prof_now - prof_t;              \
    prof_t = prof_now;                             \
  } while (0)
#define PROF_FLUSH()                                                                       \
  do {                                                                                     \
    if (prof_at >= 0)                                                                      \
      for (int prof_i = 0; prof_i < 16; ++prof_i)                                          \
        if (prof_acc[prof_i]) e2_prof[prof_at + prof_i] += (unsigned long long)prof_acc[prof_i]; \
  } while (0)
#else
#define PROF_START(on)
#define PROF(i)
#define PROF_FLUSH()
#endif

// NaN-last strict total order of (value, index): a permutation when ranked
__device__ __forceinline__ bool before(double a, int ia, double b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return nb;
  if (na || a == b) return ia < ib;
  return a < b;
}

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

// E1's rotation of the pair (p, q) (Golub & Van Loan 8.4.2): t the smaller
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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// round r's pair k of the round-robin ordering over M indices: (p, q), p < q
template <int M>
__device__ __forceinline__ void round_pair(int r, int k, int& p, int& q) {
  int P = r, Q = M - 1;
  if (k) {
    P = r + k;
    P -= P >= M - 1 ? M - 1 : 0;
    Q = r - k;
    Q += Q < 0 ? M - 1 : 0;
  }
  p = min(P, Q);
  q = max(P, Q);
}

// pair k's rotation from S, its own 2 x 2 block written (new pivots, exact
// zeros), (s, tau) and p | q << 8 to rot; pair k of round r is the round-
// robin ordering's or, with `cross`, (k, M/2 + (k + r) mod M/2)
template <int M>
__device__ __forceinline__ void rotate_pair(double* __restrict__ S, int lds, int r, int k,
                                            Rot* __restrict__ rot, bool cross = false) {
  int p, q;
  if (cross) {
    p = k;
    q = k + r;
    q = M / 2 + (q >= M / 2 ? q - M / 2 : q);
  } else {
    round_pair<M>(r, k, p, q);
  }
  const double app = S[p * lds + p], aqq = S[q * lds + q], apq = S[p * lds + q];
  double sr, tau;
  const double t = rotation(app, aqq, apq, sr, tau);
  S[p * lds + p] = app - t * apq;
  S[q * lds + q] = aqq + t * apq;
  S[p * lds + q] = S[q * lds + p] = 0.0;
  rot->st[k] = make_double2(sr, tau);
  rot->pq[k] = p | q << 8;
}

// NB off-diagonal 2 x 2 blocks (k > l) of S by one thread: the block pair
// indices e0, e0 + stride, ... below NBLK (a thread past the last block
// reloads block 0 and stores nothing); every rotation and entry loaded
// before the first store; rows (rotation k), then columns (l); the block
// and its transpose
template <int NB, int NBLK>
struct Blocks {
  int bk[NB], bl[NB];
  bool own[NB];
  __device__ __forceinline__ Blocks(int e0, int stride, bool on) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e1 = e0 + stride * i;
      own[i] = on && e1 < NBLK;
      const int e = own[i] ? e1 : 0;
      int k = 1;
      while (k * (k + 1) / 2 <= e) ++k;
      bk[i] = k;
      bl[i] = e - k * (k - 1) / 2;
    }
  }
  __device__ __forceinline__ void apply(double* __restrict__ S, int lds,
                                        const Rot* __restrict__ rot) const {
    double x[NB][4];
    double2 sk[NB], sl[NB];
    int pk[NB], pl[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      pk[i] = rot->pq[bk[i]];
      pl[i] = rot->pq[bl[i]];
      sk[i] = rot->st[bk[i]];
      sl[i] = rot->st[bl[i]];
      const int p0 = pk[i] & 255, q0 = pk[i] >> 8, p1 = pl[i] & 255, q1 = pl[i] >> 8;
      x[i][0] = S[p0 * lds + p1];
      x[i][1] = S[p0 * lds + q1];
      x[i][2] = S[q0 * lds + p1];
      x[i][3] = S[q0 * lds + q1];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const double r00 = x[i][0] - sk[i].x * (x[i][2] + x[i][0] * sk[i].y);
      const double r10 = x[i][2] + sk[i].x * (x[i][0] - x[i][2] * sk[i].y);
      const double r01 = x[i][1] - sk[i].x * (x[i][3] + x[i][1] * sk[i].y);
      const double r11 = x[i][3] + sk[i].x * (x[i][1] - x[i][3] * sk[i].y);
      const double y00 = r00 - sl[i].x * (r01 + r00 * sl[i].y);
      const double y01 = r01 + sl[i].x * (r00 - r01 * sl[i].y);
      const double y10 = r10 - sl[i].x * (r11 + r10 * sl[i].y);
      const double y11 = r11 + sl[i].x * (r10 - r11 * sl[i].y);
      if (own[i]) {
        const int p0 = pk[i] & 255, q0 = pk[i] >> 8, p1 = pl[i] & 255, q1 = pl[i] >> 8;
        S[p0 * lds + p1] = S[p1 * lds + p0] = y00;
        S[p0 * lds + q1] = S[q1 * lds + p0] = y01;
        S[q0 * lds + p1] = S[p1 * lds + q0] = y10;
        S[q0 * lds + q1] = S[q1 * lds + q0] = y11;
      }
    }
  }
};

// VT's rotated rows in column j for VP pairs from k0 (pairs past HALF are
// loaded as pair 0 and not stored), loads before stores
template <int VP, int HALF>
__device__ __forceinline__ void rotate_rows(double* __restrict__ VT, int ldv, int j, int k0,
                                            const Rot* __restrict__ rot) {
  double g[VP], h[VP];
  double2 st[VP];
  int pq[VP];
#pragma unroll
  for (int k = 0; k < VP; ++k) {
    const int kk = k0 + k < HALF ? k0 + k : 0;
    pq[k] = rot->pq[kk];
    st[k] = rot->st[kk];
    g[k] = VT[(pq[k] & 255) * ldv + j];
    h[k] = VT[(pq[k] >> 8) * ldv + j];
  }
#pragma unroll
  for (int k = 0; k < VP; ++k) {
    const double gn = g[k] - st[k].x * (h[k] + g[k] * st[k].y);
    const double hn = h[k] + st[k].x * (g[k] - h[k] * st[k].y);
    if (k0 + k < HALF) {
      VT[(pq[k] & 255) * ldv + j] = gn;
      VT[(pq[k] >> 8) * ldv + j] = hn;
    }
  }
}

// One round-robin sweep over M (even, <= WARP_N) indices by one warp on the
// symmetric M x M matrix S (pitch lds), mixing the rows of VT (M x M, pitch
// ldv) alike. Each round: every lane forms a rotation (lanes k < M/2 pair
// k's, and write its own 2 x 2 block and rot[r & 1]; the others repeat a
// pair and store nothing) while it rotates its share of VT's rows by the
// last round's rotations (column lane % M, a 32 / M share of the pairs),
// one branch-free stream; __syncwarp(); every lane updates its off-
// diagonal 2 x 2 blocks (k > l); __syncwarp(). VT's last round follows the
// loop.
template <int M>
__device__ void warp_sweep(double* __restrict__ S, int lds, double* __restrict__ VT, int ldv,
                           Rot* __restrict__ rot, bool prof) {
  constexpr int HALF = M / 2, NBLK = HALF * (HALF - 1) / 2, NB = (NBLK + 31) / 32;
  constexpr int SHARE = 32 / M, VP = (HALF + SHARE - 1) / SHARE;
  static_assert(32 % M == 0, "the small form pads to 16 or 32");
  const int lane = threadIdx.x & 31, k = lane % HALF;
  const Blocks<NB, NBLK> blocks(lane, 32, true);
  PROF_START(prof);
#pragma unroll 1
  for (int r = 0; r < M - 1; ++r) {
    int p, q;
    round_pair<M>(r, k, p, q);
    const double app = S[p * lds + p], aqq = S[q * lds + q], apq = S[p * lds + q];
    if (r > 0) rotate_rows<VP, HALF>(VT, ldv, lane % M, (lane / M) * VP, rot + ((r - 1) & 1));
    double sr, tau;
    const double t = rotation(app, aqq, apq, sr, tau);
    if (lane < HALF) {
      S[p * lds + p] = app - t * apq;
      S[q * lds + q] = aqq + t * apq;
      S[p * lds + q] = S[q * lds + p] = 0.0;
      rot[r & 1].st[k] = make_double2(sr, tau);
      rot[r & 1].pq[k] = p | q << 8;
    }
    __syncwarp();
    PROF(10);
    blocks.apply(S, lds, rot + (r & 1));
    __syncwarp();
    PROF(11);
  }
  rotate_rows<VP, HALF>(VT, ldv, lane % M, (lane / M) * VP, rot + ((M - 2) & 1));
  __syncwarp();
  PROF_FLUSH();
}

// The blocked form's inner sweep over M = SUB indices by the CTA's 8 warps:
// the round-robin sweep (M - 1 rounds) or, with `cross`, the M/2 rounds of
// the pairs across the two tiles (k, M/2 + (k + r) mod M/2). Warp-
// specialised: warp 0 forms each round's rotations (into rot[r & 1]),
// warps 0-3 update S's off-diagonal 2 x 2 blocks (one a thread; named
// barrier 1 between them), and warps 4-7 rotate VT's rows (lane j column j,
// a quarter of the pairs each) one step behind: barriers 2 + b ("rotations
// of buffer b are ready": warp 0 arrives, warps 4-7 wait) and 4 + b
// ("buffer b is free": warps 4-7 arrive, warp 0 waits before it refills
// b), b = r & 1. VT's update stays off the rounds' critical path.
template <int M>
__device__ void jacobi_sweep_cta(double* __restrict__ S, int lds, double* __restrict__ VT,
                                 int ldv, Rot* __restrict__ rot, bool cross, bool prof) {
  constexpr int HALF = M / 2, NBLK = HALF * (HALF - 1) / 2, NB = (NBLK + 127) / 128;
  constexpr int VP = (HALF + 3) / 4, PAIR = 32 + 128;  // warp 0 and warps 4-7
  const int gt = threadIdx.x, lane = gt & 31, rounds = cross ? HALF : M - 1;
  if (gt < 128) {
    const Blocks<NB, NBLK> blocks(gt, 128, true);
    PROF_START(prof);
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      Rot* R = rot + (r & 1);
      if (gt < 32) {
        if (r >= 2) bar_sync(4 + (r & 1), PAIR);
        if (gt < HALF) rotate_pair<M>(S, lds, r, gt, R, cross);
        bar_arrive(2 + (r & 1), PAIR);
      }
      bar_sync(1, 128);
      PROF(10);
      blocks.apply(S, lds, R);
      bar_sync(1, 128);
      PROF(11);
    }
    if (gt < 32) {  // the last two rounds' buffers
      bar_sync(4 + ((rounds - 2) & 1), PAIR);
      bar_sync(4 + ((rounds - 1) & 1), PAIR);
    }
    PROF_FLUSH();
  } else {
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      const Rot* R = rot + (r & 1);
      bar_sync(2 + (r & 1), PAIR);
      if (lane < M) rotate_rows<VP, HALF>(VT, ldv, lane, ((gt >> 5) - 4) * VP, R);
      bar_arrive(4 + (r & 1), PAIR);
    }
  }
}

// the stopping test over S (m x m, pitch lds) by one warp: every lane
// gets the same answer
__device__ __forceinline__ bool warp_converged(const double* S, int lds, int m) {
  const int lane = threadIdx.x & 31;
  const double eps = DBL_EPSILON * 0.5;
  double off = 0.0, diag = 0.0;
  for (int e = lane; e < m * m; e += 32) {
    const int i = e / m, j = e - i * m;
    const double x = S[i * lds + j];
    if (i < j) off += x * x;
    else if (i == j) diag += x * x;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {  // every lane ends with the same sums
    off += __shfl_xor_sync(FULL, off, o);
    diag += __shfl_xor_sync(FULL, diag, o);
  }
  return !(off > eps * eps * diag);  // converged (or NaN: stop)
}

// ---------------------------------------------------------------------------
// (a) the small form: n padded to M = 16 (n <= 16) or 32

template <int M>
__global__ void __launch_bounds__(32 * SMALL_WARPS)
sym_eig_small_kernel(const double* __restrict__ A, double* __restrict__ L,
                     double* __restrict__ V, int* __restrict__ sweeps, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = M + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * SMALL_WARPS + warp;
  if (b >= B) return;  // no block barrier below
  double* S = reinterpret_cast<double*>(smem) + (size_t)warp * 2 * M * LD;
  double* VT = S + M * LD;
  Rot* rot = reinterpret_cast<Rot*>(reinterpret_cast<double*>(smem) +
                                    (size_t)SMALL_WARPS * 2 * M * LD) + 2 * warp;
  const double* Ab = A + (size_t)b * n * n;
  for (int e = lane; e < M * M; e += 32) {
    const int i = e / M, j = e - i * M;
    double x = 0.0;
    if (i < n && j < n) x = i >= j ? Ab[i * n + j] : Ab[j * n + i];
    S[i * LD + j] = x;
    VT[i * LD + j] = i == j ? 1.0 : 0.0;
  }
  __syncwarp();
  int sweep = 0;
  while (sweep < MAX_SWEEPS && !warp_converged(S, LD, M)) {
    warp_sweep<M>(S, LD, VT, LD, rot, b == 0 && lane == 0);
    ++sweep;
  }
  double* Lb = L + (size_t)b * n;
  double* Vb = V + (size_t)b * n * n;
  for (int i = lane; i < n; i += 32) {
    const double d = S[i * LD + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(S[j * LD + j], j, d, i);
    Lb[rank] = d;
    for (int k = 0; k < n; ++k) Vb[k * n + rank] = VT[i * LD + k];
  }
  if (lane == 0) sweeps[b] = sweep;
}

template <int M>
__host__ size_t small_smem_bytes() {
  return (size_t)SMALL_WARPS * (2 * sizeof(double) * M * (M + 1) + 2 * sizeof(Rot));
}

// ---------------------------------------------------------------------------
// (b) the blocked form

// the tile in slot (0 or 1) of CTA k in round r of the circle ordering over
// nb tiles: (r, nb - 1) for k = 0, ((r + k), (r - k)) mod (nb - 1) else
__device__ __forceinline__ int tile_of(int k, int slot, int r, int nb) {
  const int M = nb - 1;
  if (k == 0) return slot ? M : r;
  return slot ? (r - k + M) % M : (r + k) % M;
}

// the column (global index) of local column l of the tile pair (tI, tJ)
__device__ __forceinline__ int col_of(int l, int tI, int tJ) {
  return l < TILE ? TILE * tI + l : TILE * tJ + l - TILE;
}

// (k, slot) -> the next round's (k', slot') of the circle ordering: CTA 0
// keeps slot 1 and sends slot 0 to (1, 1); CTA k >= 1 sends slot 0 to
// (k - 1, 0) and slot 1 to (k + 1, 1), or to its own slot 0 when it is the
// last CTA
__device__ __forceinline__ void next_slot(int c, int slot, int nc, int& k, int& s) {
  if (slot == 0) {
    k = c == 0 ? 1 : c - 1;
    s = c == 0 ? 1 : 0;
  } else {
    k = c == 0 ? 0 : (c + 1 < nc ? c + 1 : c);
    s = c == 0 || c + 1 < nc ? 1 : 0;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// D (8 x 8) += A (8 x 4) B (4 x 8) on the FP64 tensor cores: lane l holds
// a = A[l / 4][l % 4], b = B[l % 4][l / 4], d0, d1 = D[l / 4][2 (l % 4) + 0, 1]
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// the row pitch of A's and V's rows: at least nt, 4 mod 16 doubles (16-byte
// rows; the tensor-core fragments' loads, 4 rows x 8 columns or 8 x 4, hit
// 16 different 8-byte banks in each half-warp)
__host__ __device__ inline int row_pitch(int nt) { return nt + ((4 - nt) % 16 + 16) % 16; }

struct Shared {
  double* arow;    // SUB x ldr: A's rows of this CTA's tile pair
  double* anext;   // SUB x ldr: where the next round's rows arrive (double buffering), or null
  double* vrow;    // QP x ldr: V's rows [c rv, c rv + rv) (fixed)
  double* qall;    // nc x QP x QLD: every CTA's Q^T of the round (slot c its own)
  double* sub;     // SUB x SUB_LD: the pair's diagonal block
  double* part;    // 2 x CLUSTER_MAX: each CTA's share of the stopping test
  double* diag;    // nt: the final diagonal
  double* red;     // 2 x WARPS
  Rot* rot;        // 2: the inner solve's rotations, by round parity
  int* rank;       // nt
};

// shared bytes of the blocked form at nb tiles, with a second buffer for
// A's rows (dbuf) or without
__host__ __device__ inline size_t cluster_smem_bytes(int nb, bool dbuf) {
  const int nt = nb * TILE, ldr = row_pitch(nt), nc = nb / 2;
  const size_t base = sizeof(double) * ((size_t)(SUB + QP) * ldr + (size_t)nc * QP * QLD +
                                        SUB * SUB_LD + 2 * CLUSTER_MAX + nt + 2 * WARPS) +
                      2 * sizeof(Rot) + nt * sizeof(int);
  return dbuf ? (base + 15) / 16 * 16 + sizeof(double) * SUB * ldr : base;
}

// this CTA's share of the stopping test over its rows of A (tiles tI, tJ),
// to slot c of every CTA's `part`
__device__ void publish_test(cg::cluster_group& cluster, const Shared& sh, int ldr, int n,
                             int tI, int tJ, int c, int nc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double off = 0.0, diag = 0.0;
  for (int e = tid; e < SUB * n; e += THREADS) {
    const int li = e / n, j = e - li * n;
    const int g = col_of(li, tI, tJ);
    if (g >= n) continue;
    const double x = sh.arow[li * ldr + j];
    if (j > g) off += x * x;
    else if (j == g) diag += x * x;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    off += __shfl_xor_sync(FULL, off, o);
    diag += __shfl_xor_sync(FULL, diag, o);
  }
  if (lane == 0) {
    sh.red[warp] = off;
    sh.red[WARPS + warp] = diag;
  }
  __syncthreads();
  if (tid < nc) {
    off = 0.0;
    diag = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      off += sh.red[w];
      diag += sh.red[WARPS + w];
    }
    double* part = cluster.map_shared_rank(sh.part, tid);
    part[2 * c] = off;
    part[2 * c + 1] = diag;
  }
}

// rows 16 mh .. 16 mh + 15 of X[0 .. rows, P_d] <- X[0 .. rows, P_d] Q_d for
// the tile pair (dI, dJ) of Q^T_d = qd, by one warp: two row tiles by the
// column tiles of P_d's 30 columns (padded to 32) below n, eight m8n8k4
// products each; Q_d's fragments loaded once for both row tiles, and every
// fragment loaded before the first store
__device__ __forceinline__ void mix_columns(double* X, int ldr, int rows, int n, int dI, int dJ,
                                            const double* qd, int mh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ntn = TILE * dJ < n ? 4 : 2;  // P_d's second tile past n: its column tiles skipped
  double ya[2][8];
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2) {
    const int row = 16 * mh + 8 * m2 + g;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int l = 4 * ks + t4;
      ya[m2][ks] = row < rows && l < SUB ? X[row * ldr + col_of(l, dI, dJ)] : 0.0;
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt >= ntn) break;
    double b[8];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) b[ks] = qd[(8 * nt + g) * QLD + 4 * ks + t4];  // Q_d[l][j]
    double d[2][2] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2) dmma(d[m2][0], d[m2][1], ya[m2][ks], b[ks]);
    }
#pragma unroll
    for (int m2 = 0; m2 < 2; ++m2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * mh + 8 * m2 + g, jj = 8 * nt + 2 * t4 + i;
        const int col = jj < SUB ? col_of(jj, dI, dJ) : n;
        if (row < rows && col < n) X[row * ldr + col] = d[m2][i];
      }
    }
  }
}

// a 16-byte store into a peer's shared memory: `local` is this CTA's copy of
// the address, `rank` the peer
__device__ __forceinline__ void st_cluster(const void* local, unsigned rank, double2 v) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"((unsigned)__cvta_generic_to_shared(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};" ::"r"(addr), "d"(v.x), "d"(v.y)
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
sym_eig_cluster_kernel(const double* __restrict__ A, double* __restrict__ L,
                       double* __restrict__ V, int* __restrict__ sweeps, int n, int nb,
                       int dbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = nb / 2, c = (int)cluster.block_rank(), b = blockIdx.x / nc;
  const int nt = nb * TILE, ldr = row_pitch(nt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rv = (n + nc - 1) / nc, v_lo = c * rv, v_rows = max(0, min(rv, n - v_lo));
  const bool prof = blockIdx.x < nc && tid == 0;  // matrix 0's CTAs
  PROF_START(prof);
  Shared sh;
  sh.arow = reinterpret_cast<double*>(smem);
  sh.vrow = sh.arow + SUB * ldr;
  sh.qall = sh.vrow + QP * ldr;
  sh.sub = sh.qall + nc * QP * QLD;
  sh.part = sh.sub + SUB * SUB_LD;
  sh.diag = sh.part + 2 * CLUSTER_MAX;
  sh.red = sh.diag + nt;
  sh.rot = reinterpret_cast<Rot*>(sh.red + 2 * WARPS);
  sh.rank = reinterpret_cast<int*>(sh.rot + 2);
  sh.anext = dbuf ? reinterpret_cast<double*>(smem + (cluster_smem_bytes(nb, false) + 15) / 16 * 16)
                  : nullptr;

  // A's rows of round 0's tiles (A's columns past n stay zero throughout:
  // the padding) and V = I's rows
  const double* Ab = A + (size_t)b * n * n;
  {
    const int tI = tile_of(c, 0, 0, nb), tJ = tile_of(c, 1, 0, nb);
    for (int e = tid; e < QP * ldr; e += THREADS) {
      const int li = e / ldr, j = e - li * ldr;
      if (li < SUB) {
        const int gr = col_of(li, tI, tJ);
        double x = 0.0;
        if (gr < n && j < n) x = gr >= j ? Ab[(size_t)gr * n + j] : Ab[(size_t)j * n + gr];
        sh.arow[e] = x;
        if (dbuf) sh.anext[e] = 0.0;  // its columns past n stay zero too
      }
      sh.vrow[e] = li < v_rows && v_lo + li == j ? 1.0 : 0.0;
    }
    cluster.sync();  // every CTA has started before any writes to a peer
    publish_test(cluster, sh, ldr, n, tI, tJ, c, nc);
    cluster.sync();
  }
  PROF(0);
  const double eps = DBL_EPSILON * 0.5;
  auto converged = [&]() {
    double off = 0.0, diag = 0.0;
    for (int d = 0; d < nc; ++d) {  // the same order in every CTA
      off += sh.part[2 * d];
      diag += sh.part[2 * d + 1];
    }
    return !(off > eps * eps * diag);
  };

  int sweep = 0;
#pragma unroll 1
  for (; sweep < MAX_SWEEPS && !converged(); ++sweep) {
#pragma unroll 1
    for (int r = 0; r < nb - 1; ++r) {
      const int tI = tile_of(c, 0, r, nb), tJ = tile_of(c, 1, r, nb);
      double* qt = sh.qall + c * QP * QLD;
      // 1. the pair's diagonal block and its inner sweep; Q^T_c starts as
      //    the 32 x 32 identity
      for (int e = tid; e < QP * QP; e += THREADS) {
        const int li = e / QP, lj = e % QP;
        if (li < SUB && lj <= li) {
          const double x = sh.arow[li * ldr + col_of(lj, tI, tJ)];
          sh.sub[li * SUB_LD + lj] = x;
          sh.sub[lj * SUB_LD + li] = x;
        }
        qt[li * QLD + lj] = li == lj ? 1.0 : 0.0;
      }
      __syncthreads();
      PROF(1);
      jacobi_sweep_cta<SUB>(sh.sub, SUB_LD, qt, QLD, sh.rot, r > 0, prof);
      __syncthreads();
      PROF(2);
      for (int e = tid; e < SUB * SUB; e += THREADS) {
        const int li = e / SUB, lj = e - li * SUB, col = col_of(lj, tI, tJ);
        if (col < n) sh.arow[li * ldr + col] = sh.sub[li * SUB_LD + lj];
      }
      for (int e = tid; e < (nc - 1) * QP * QLD / 2; e += THREADS) {
        const int dd = e / (QP * QLD / 2), at = e - dd * (QP * QLD / 2);
        const double2* q2 = reinterpret_cast<const double2*>(qt) + at;
        st_cluster(q2, dd < c ? dd : dd + 1, *q2);
      }
      cluster_arrive();
      PROF(3);
      // 2. rows: A[R, j] <- Q^T_c A[R, j] for A's columns outside the pair
      //    (below n), a warp per 8 of them on the tensor cores, Q^T_c's
      //    fragments held in registers
      {
        const int ta = min(tI, tJ), tb = max(tI, tJ);
        const int cols = n - min(TILE, max(0, n - TILE * ta)) - min(TILE, max(0, n - TILE * tb));
        auto outside = [ta, tb](int jj) {
          jj += jj >= TILE * ta ? TILE : 0;
          return jj + (jj >= TILE * tb ? TILE : 0);
        };
        double qa[4][8];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) qa[mt][ks] = qt[(8 * mt + g) * QLD + 4 * ks + t4];
        }
#pragma unroll 1
        for (int n0 = 8 * warp; n0 < cols; n0 += 8 * WARPS) {
          const int jb = n0 + g, jcol = jb < cols ? outside(jb) : 0;
          double bf[8];
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const int k = 4 * ks + t4;
            bf[ks] = jb < cols && k < SUB ? sh.arow[k * ldr + jcol] : 0.0;
          }
          double d[4][2] = {};
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int ks = 0; ks < 8; ++ks) dmma(d[mt][0], d[mt][1], qa[mt][ks], bf[ks]);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = 8 * mt + g, jj = n0 + 2 * t4 + i;
              if (row < SUB && jj < cols) sh.arow[row * ldr + outside(jj)] = d[mt][i];
            }
          }
        }
      }
      __syncthreads();
      PROF(4);
      cluster_wait();  // every CTA's Q^T has arrived
      PROF(5);
      // 3. columns by every Q_d: A's rows in every other pair's block, V's
      //    rows in every pair's block; a warp per (matrix, block)
#pragma unroll 1
      for (int task = warp; task < 2 * (2 * nc - 1); task += WARPS) {
        const int blk = task >> 1, mh = task & 1;
        const bool on_a = blk < nc - 1;
        const int d = on_a ? (blk < c ? blk : blk + 1) : blk - (nc - 1);
        mix_columns(on_a ? sh.arow : sh.vrow, ldr, on_a ? SUB : v_rows, n, tile_of(d, 0, r, nb),
                    tile_of(d, 1, r, nb), sh.qall + d * QP * QLD, mh);
      }
      __syncthreads();
      PROF(6);
      if (r == nb - 2) publish_test(cluster, sh, ldr, n, tI, tJ, c, nc);
#ifdef PVIO_E2_PROFILE
      cluster.sync();  // the phase counters: the wait for the slowest CTA apart
#endif
      PROF(7);
      // 4. A's rows to their CTAs of the next round in 4-column segments:
      //    with a second buffer straight into the peer's free one, then a
      //    cluster barrier, and the buffers swap; else through registers,
      //    between two cluster barriers
      if (dbuf) {
        const int segs = (n + 3) / 4, items = SUB * segs;
#pragma unroll 1
        for (int it = tid; it < items; it += THREADS) {
          const int li = it / segs, s4 = 4 * (it % segs);
          int k, slot;
          next_slot(c, li / TILE, nc, k, slot);
          const double2* src = reinterpret_cast<const double2*>(sh.arow + li * ldr + s4);
          const double* dst = sh.anext + (slot * TILE + li % TILE) * ldr + s4;
          st_cluster(dst, k, src[0]);
          st_cluster(dst + 2, k, src[1]);
        }
        cluster.sync();
        double* t = sh.arow;
        sh.arow = sh.anext;
        sh.anext = t;
      } else {
        const int segs = (n + 3) / 4, items = SUB * segs;
        double2 keep[MOVE][2];
#pragma unroll
        for (int i = 0; i < MOVE; ++i) {
          const int it = tid + THREADS * i;
          if (it < items) {
            const double2* src =
                reinterpret_cast<const double2*>(sh.arow + (it / segs) * ldr + 4 * (it % segs));
            keep[i][0] = src[0];
            keep[i][1] = src[1];
          }
        }
        cluster.sync();
#pragma unroll
        for (int i = 0; i < MOVE; ++i) {
          const int it = tid + THREADS * i;
          if (it < items) {
            const int li = it / segs, s4 = 4 * (it % segs);
            int k, slot;
            next_slot(c, li / TILE, nc, k, slot);
            const double* dst = sh.arow + (slot * TILE + li % TILE) * ldr + s4;
            st_cluster(dst, k, keep[i][0]);
            st_cluster(dst + 2, k, keep[i][1]);
          }
        }
        cluster.sync();
      }
      PROF(8);
    }
  }

  // the layout is round 0's again: every CTA ranks every eigenvalue
  {
    const int tI = tile_of(c, 0, 0, nb), tJ = tile_of(c, 1, 0, nb);
    if (tid < SUB) {
      const int gr = col_of(tid, tI, tJ);
      if (gr < n) {
        const double d = sh.arow[tid * ldr + gr];
        for (int k = 0; k < nc; ++k) cluster.map_shared_rank(sh.diag, k)[gr] = d;
      }
    }
  }
  cluster.sync();  // the last access to a peer's shared memory
  if (tid < n) {
    const double d = sh.diag[tid];
    int rank = 0;
    for (int k = 0; k < n; ++k) rank += before(sh.diag[k], k, d, tid);
    sh.rank[tid] = rank;
    if (c == 0) L[(size_t)b * n + rank] = d;
  }
  __syncthreads();
  double* Vb = V + (size_t)b * n * n;
  for (int e = tid; e < v_rows * n; e += THREADS) {
    const int li = e / n, k = e - li * n;
    Vb[(size_t)(v_lo + li) * n + sh.rank[k]] = sh.vrow[li * ldr + k];
  }
  if (c == 0 && tid == 0) sweeps[b] = sweep;
  PROF(9);
  PROF_FLUSH();
}

__host__ inline int tiles(int n) {
  const int nb = (n + TILE - 1) / TILE;
  return nb + (nb & 1);
}

// a second buffer for A's rows where it fits (n <= 210; not at n = 240)
__host__ inline bool double_buffered(int n) {
  return cluster_smem_bytes(tiles(n), true) <= SMEM_LIMIT;
}

__host__ cudaError_t cluster_config(int n, int B, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                                    cudaLaunchAttribute& attr) {
  const int nb = tiles(n);
  const size_t smem = cluster_smem_bytes(nb, double_buffered(n));
  const cudaError_t err = cudaFuncSetAttribute(
      sym_eig_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * (nb / 2));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nb / 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int M>
__host__ int launch_small(const double* a, double* l, double* v, int* sw, int B, int n,
                          cudaStream_t st) {
  const size_t smem = small_smem_bytes<M>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sym_eig_small_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sym_eig_small_kernel<M><<<(B + SMALL_WARPS - 1) / SMALL_WARPS, 32 * SMALL_WARPS, smem, st>>>(
      a, l, v, sw, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef PVIO_E2_PROFILE
// copy the phase counters to out[16 * CLUSTER_MAX] and zero them
extern "C" int pvio_sym_eig_block_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, e2_prof, sizeof(e2_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[16 * CLUSTER_MAX] = {};
  return (int)cudaMemcpyToSymbol(e2_prof, zero, sizeof(e2_prof));
}
#endif

extern "C" int pvio_sym_eig_block_max_n() { return N_MAX; }

extern "C" int pvio_sym_eig_block_max_sweeps() { return MAX_SWEEPS; }

extern "C" int pvio_sym_eig_block_warp_n() { return WARP_N; }

extern "C" int pvio_sym_eig_block_tile() { return TILE; }

extern "C" int pvio_sym_eig_block_max_clusters(int n) {
  if (n <= WARP_N || n > N_MAX) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_config(n, 1, nullptr, cfg, attr) != cudaSuccess) return -1;
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, sym_eig_cluster_kernel, &cfg) != cudaSuccess)
    return -1;
  return count;
}

extern "C" int pvio_sym_eig_block(const void* A, void* L, void* V, void* /*scratch*/,
                                  void* sweeps, int B, int n, void* stream) {
  if (B <= 0 || n < 1 || n > N_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(A);
  double* l = static_cast<double*>(L);
  double* v = static_cast<double*>(V);
  int* sw = static_cast<int*>(sweeps);
  if (n <= 16) return launch_small<16>(a, l, v, sw, B, n, st);
  if (n <= WARP_N) return launch_small<WARP_N>(a, l, v, sw, B, n, st);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(n, B, st, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, sym_eig_cluster_kernel, a, l, v, sw, n, tiles(n),
                           double_buffered(n) ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
