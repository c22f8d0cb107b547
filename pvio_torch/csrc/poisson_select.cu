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
// Design: one block per image, one thread per candidate (C <= 1024). The
// positions live in shared memory (8 or 16 B a candidate) with two byte
// flags a candidate (alive, winner). A round is two passes over shared
// memory: each alive thread scans the earlier candidates until it finds an
// alive neighbour (dominated), then each alive loser scans the winners until
// it finds a neighbour (killed). __syncthreads_or(alive) ends the loop on
// the device, and thread 0 writes the round count to `rounds[b]`.
//
// Bound: the bytes are tiny (C x 2 positions and a mask in, a mask out:
// ~10 KB an image at C = 1024 in float32), so operations bound it: the
// squared distances among the initially alive candidates, 5 operations a
// pair, at the card's 67 TFLOP/s of FP32 (tens of ns for one image). A
// launch and the block's serial rounds (a few, each O(C) per thread) set
// its time; the loop's early exits make the work data-dependent.
//
// Plain C interface for ctypes:
//   pvio_poisson_select(cand, alive, selected, rounds, B, C, d2, is_double,
//     stream) launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float dist2(float xi, float yi, float xj, float yj) {
  const float dx = __fsub_rn(xi, xj), dy = __fsub_rn(yi, yj);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ double dist2(double xi, double yi, double xj, double yj) {
  const double dx = __dsub_rn(xi, xj), dy = __dsub_rn(yi, yj);
  return __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy));
}

template <typename T>
__global__ void __launch_bounds__(1024)
poisson_select_kernel(const T* __restrict__ cand, const bool* __restrict__ alive_in,
                      bool* __restrict__ selected, int* __restrict__ rounds, int C, T d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);
  T* sy = sx + C;
  unsigned char* s_alive = reinterpret_cast<unsigned char*>(sy + C);
  unsigned char* s_win = s_alive + C;

  const int b = blockIdx.x, i = threadIdx.x;
  cand += (size_t)b * C * 2;
  alive_in += (size_t)b * C;
  selected += (size_t)b * C;

  T xi = 0, yi = 0;
  bool alive = false, sel = false;
  if (i < C) {
    xi = cand[2 * i];
    yi = cand[2 * i + 1];
    sx[i] = xi;
    sy[i] = yi;
    alive = alive_in[i];
  }
  int n = 0;
  // n is the same in every thread, so every thread reaches the barrier
  while (n < C && __syncthreads_or(alive)) {
    if (i < C) s_alive[i] = alive;
    __syncthreads();
    bool dominated = false;
    if (alive) {
      for (int j = 0; j < i; ++j) {
        if (s_alive[j] && dist2(xi, yi, sx[j], sy[j]) < d2) {
          dominated = true;
          break;
        }
      }
    }
    const bool win = alive && !dominated;
    if (i < C) s_win[i] = win;
    __syncthreads();
    bool killed = false;
    if (alive && !win) {
      for (int j = 0; j < C; ++j) {
        if (s_win[j] && dist2(xi, yi, sx[j], sy[j]) < d2) {
          killed = true;
          break;
        }
      }
    }
    sel = sel || win;
    alive = alive && !win && !killed;
    ++n;
  }
  if (i < C) selected[i] = sel;
  if (i == 0) rounds[b] = n;
}

template <typename T>
int launch(const void* cand, const void* alive, void* selected, void* rounds, int B, int C,
           double d2, cudaStream_t stream) {
  const int threads = (C + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)C * sizeof(T) + 2 * (size_t)C;
  poisson_select_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(cand), static_cast<const bool*>(alive),
      static_cast<bool*>(selected), static_cast<int*>(rounds), C, static_cast<T>(d2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pvio_poisson_select(const void* cand, const void* alive, void* selected,
                                   void* rounds, int B, int C, double d2, int is_double,
                                   void* stream) {
  if (B <= 0 || C <= 0 || C > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(cand, alive, selected, rounds, B, C, d2, s)
                   : launch<float>(cand, alive, selected, rounds, B, C, d2, s);
}
