// Kernel S1: greedy Poisson-disk selection of response-sorted corner
// candidates, in parallel rounds, for Hopper. A kernel of the port only: the
// reference computes the same rounds as XLA array code in a lax.while_loop
// (pvio_tpu/frontend/detect.py:131-151), which runs on the device with no
// host read. The port's plain version (pvio_torch/ops/poisson.py::
// select_candidates_plain) runs the rounds from Python and has to ask the
// host whether any candidate is alive after each one; this kernel runs them
// all on the card.
//
// For each image b of a batch of B, with C candidates (x, y) sorted by
// response and an alive mask:
//   near(i, j) = (x_i - x_j)^2 + (y_i - y_j)^2 < d2          (self included)
//   repeat while some candidate is alive (at most C rounds):
//     winners  = alive i with no alive j < i near i
//     selected |= winners
//     alive    &= !winners & !(some winner near i)
// The result equals the plain version bit for bit: the squared distance is
// formed in the candidates' type with one rounding per operation, as
// PyTorch forms it ((x_i - x_j) ** 2 summed over the two coordinates);
// __fmul_rn / __fadd_rn (and the double forms) keep nvcc from contracting
// dx * dx + dy * dy into an FMA, which rounds once and would flip a pair that
// lies exactly on min_distance. d2 arrives as a double and is rounded to the
// candidates' type, as PyTorch rounds a Python scalar in `dist2 < d2`.
//
// Only pairs j < i matter: an alive i loses to an alive j < i near it, and a
// winner j near an alive i always has j < i (were j > i, the alive i would
// dominate it). So the relation kept is the strict lower triangle of near
// among the initially alive candidates.
//
// Design: one thread block cluster of CLUSTER = 8 CTAs per image (8 is the
// portable cluster size; B = 11 images make 88 CTAs on the card's 132 SMs),
// 1024 threads each (C <= 1024):
//   1. each CTA loads the image's candidates and compacts the alive ones in
//      order with a block prefix sum (ballot + popc per warp), so the pair
//      work is n_alive^2 / 2, not C^2 / 2;
//   2. the n_alive rows are cut into 32-row words, and each CTA owns a run
//      of ceil(words / 8) of them. It builds its rows' neighbour relation
//      once, bit-packed: one warp per row, each lane one column j of a
//      32-column word, __ballot_sync packs the word (row pitch 33 words, so
//      a warp reading one word of 32 rows hits 32 banks);
//   3. a round is one warp per owned word, one lane per row: dominated(i) =
//      any over words of (near_row_i & alive), a ballot forms the winner
//      word, lane 0 writes it into every CTA's copy (distributed shared
//      memory), cluster.sync(); killed(i) = any(near_row_i & winners), a
//      ballot forms the new alive word, lane 0 writes it into every CTA's
//      copy, cluster.sync(). Every CTA then holds the whole alive mask and
//      the loop ends, on the device, when it is empty. Thread 0 of the
//      cluster's first CTA writes the round count to `rounds[b]`.
//
// Bound: the bytes are tiny (C x 2 positions and a mask in, a mask out:
// ~10 KB an image at C = 1024 in float32), so operations bound it: the
// squared distances among the initially alive candidates, 5 operations a
// pair, at the card's 67 TFLOP/s of FP32 (tens of ns for one image). A
// launch, the compaction's barriers, the relation's build (the last CTA's
// rows are the longest) and two cluster barriers per round set its time;
// the rounds' early exit makes the work data-dependent.
//
// Plain C interface for ctypes:
//   pvio_poisson_select(cand, alive, selected, rounds, B, C, d2, is_double,
//     stream) launches on `stream` and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int C_MAX = 1024;
constexpr int THREADS = 1024;
constexpr int CLUSTER = 8;
constexpr int WORDS_MAX = C_MAX / 32;
constexpr int ROWS_MAX = ((WORDS_MAX + CLUSTER - 1) / CLUSTER) * 32;  // rows a CTA owns
constexpr int PITCH = WORDS_MAX + 1;                                   // words a row

__device__ __forceinline__ float dist2(float xi, float yi, float xj, float yj) {
  const float dx = __fsub_rn(xi, xj), dy = __fsub_rn(yi, yj);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ double dist2(double xi, double yi, double xj, double yj) {
  const double dx = __dsub_rn(xi, xj), dy = __dsub_rn(yi, yj);
  return __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy));
}

// write `word` into slot w of `arr` in every CTA of the cluster
__device__ __forceinline__ void publish(cg::cluster_group& cluster, uint32_t* arr, int w,
                                        uint32_t word) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) cluster.map_shared_rank(arr, r)[w] = word;
}

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
poisson_select_kernel(const T* __restrict__ cand, const bool* __restrict__ alive_in,
                      bool* __restrict__ selected, int* __restrict__ rounds, int C, T d2) {
  __shared__ T cx[C_MAX], cy[C_MAX];
  __shared__ int16_t orig[C_MAX];
  __shared__ uint32_t near[ROWS_MAX * PITCH];
  __shared__ uint32_t alive[WORDS_MAX], win[WORDS_MAX];
  __shared__ int scan[32];
  __shared__ int s_n_alive;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  cand += (size_t)b * C * 2;
  alive_in += (size_t)b * C;
  selected += (size_t)b * C;

  // 1. compact the alive candidates, in order
  const bool a0 = t < C && alive_in[t];
  const uint32_t ballot = __ballot_sync(0xffffffffu, a0);
  if (lane == 0) scan[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int v = scan[lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    scan[lane] = incl - v;
    if (lane == 31) s_n_alive = incl;
  }
  __syncthreads();
  if (a0) {
    const int pos = scan[warp] + __popc(ballot & ((1u << lane) - 1u));
    cx[pos] = cand[2 * t];
    cy[pos] = cand[2 * t + 1];
    orig[pos] = (int16_t)t;
  }
  if (t < C && !a0 && t % CLUSTER == rank) selected[t] = false;  // never alive
  const int n_alive = s_n_alive, words = (n_alive + 31) / 32;
  const int per = (words + CLUSTER - 1) / CLUSTER;
  const int w0 = min(words, rank * per), w1 = min(words, w0 + per);
  const int row0 = 32 * w0, rows = min(n_alive, 32 * w1) - row0;
  if (t < WORDS_MAX) {
    const int left = n_alive - 32 * t;
    alive[t] = left >= 32 ? 0xffffffffu : (left > 0 ? (1u << left) - 1u : 0u);
  }
  __syncthreads();

  // 2. this CTA's rows of the strict lower triangle of near, bit-packed
  for (int lr = warp; lr < rows; lr += THREADS / 32) {
    const int i = row0 + lr;
    const T xi = cx[i], yi = cy[i];
    for (int u = 0; u <= i / 32; ++u) {
      const int j = 32 * u + lane;
      const bool nr = j < i && dist2(xi, yi, cx[j], cy[j]) < d2;
      const uint32_t word = __ballot_sync(0xffffffffu, nr);
      if (lane == 0) near[lr * PITCH + u] = word;
    }
  }
  // every CTA of the cluster has started and built its rows before any
  // writes into another's shared memory
  cluster.sync();

  // 3. the rounds: warp k handles word w0 + k, lane l its row 32 (w0 + k) + l
  const int lr = 32 * warp + lane, i = row0 + lr, w = w0 + warp;
  const bool mine = warp < w1 - w0;
  const bool row = mine && lr < rows;
  bool sel = false, any = n_alive > 0;
  int n = 0;
  while (n < C && any) {
    bool win_i = false, alive_i = false;
    if (mine) {
      alive_i = row && ((alive[w] >> lane) & 1u);
      uint32_t hit = 0;
      if (alive_i)
        for (int u = 0; u <= w; ++u) hit |= near[lr * PITCH + u] & alive[u];
      win_i = alive_i && !hit;
      const uint32_t word = __ballot_sync(0xffffffffu, win_i);
      if (lane == 0) publish(cluster, win, w, word);
    }
    cluster.sync();
    if (mine) {
      uint32_t hit = 0;
      if (alive_i && !win_i)
        for (int u = 0; u <= w; ++u) hit |= near[lr * PITCH + u] & win[u];
      const uint32_t word = __ballot_sync(0xffffffffu, alive_i && !win_i && !hit);
      if (lane == 0) publish(cluster, alive, w, word);
    }
    sel = sel || win_i;
    cluster.sync();
    any = false;
    for (int u = 0; u < words; ++u) any = any || alive[u] != 0u;
    ++n;
  }
  if (row) selected[orig[i]] = sel;
  if (rank == 0 && t == 0) rounds[b] = n;
}

template <typename T>
int launch(const void* cand, const void* alive, void* selected, void* rounds, int B, int C,
           double d2, cudaStream_t stream) {
  poisson_select_kernel<T><<<B * CLUSTER, THREADS, 0, stream>>>(
      static_cast<const T*>(cand), static_cast<const bool*>(alive),
      static_cast<bool*>(selected), static_cast<int*>(rounds), C, static_cast<T>(d2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pvio_poisson_select(const void* cand, const void* alive, void* selected,
                                   void* rounds, int B, int C, double d2, int is_double,
                                   void* stream) {
  if (B <= 0 || C <= 0 || C > C_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(cand, alive, selected, rounds, B, C, d2, s)
                   : launch<float>(cand, alive, selected, rounds, B, C, d2, s);
}
