// Fused Shi-Tomasi (GFTT minimum-eigenvalue) corner response for Hopper.
//
// Replaces the Pallas TPU kernel pvio_tpu/ops/stencil.py:_shi_tomasi_kernel
// (entered through shi_tomasi_response_tpu). For each (H, W) image of a
// stack of B (B = 1 for one image; under the reference's vmap of the chain,
// one per sequence), float32, or float64 for a float64 image:
//   gx, gy  = Scharr / 32 gradients of the zero-padded image,
//   a, b, c = 3x3 box means of gx*gx, gx*gy, gy*gy, where a product at a
//             position outside the image counts as 0,
//   out     = (a + c) / 2 - sqrt(((a - c) / 2)^2 + b^2).
// That is the plain version pvio_torch/frontend/detect.py::
// shi_tomasi_response over the WHOLE image: the TPU kernel's circular-shift
// garbage in the 2-px border does not exist here, and the interior is the
// same function.
//
// Bound: the kernel must read each image once and write each response once,
// 2 * B * H * W * 4 bytes -- about 2.9 MB at 480x752, i.e. about 0.86 us at
// the H100's 3.35 TB/s for one image, and 31.8 MB, 9.48 us, for B = 11. Its
// ~57 flops a pixel take ~0.31 us (B = 1) at 67 TFLOP/s of FP32, so bytes
// bound it. Both are below what a launch costs the device
// (an empty kernel of this grid takes ~0.87 us), so the design aims at the
// fixed costs: how many waves, how long a block waits for its input, and how
// many instructions stand between that input and the stores.
//
// Design:
//   * One wave per image. Each block owns a TH x TW = 24 x 128 output tile,
//     so 480x752 takes 20 x 6 = 120 blocks on the card's 132 SMs (grid z is
//     the image of the stack: B x 120 blocks); each thread owns 4
//     adjacent output columns and RUN = 2 output rows, so a warp spans a
//     tile row (384 threads a block). Tile and RUN were chosen by
//     measurement (sweep_k1_tiles.py times other values of TH, TW and RUN;
//     PERF.md).
//   * One load per block. The (TH+4) x (TW+8) input box (15.2 KB) holds the
//     tile with its 2-px halo; it arrives in shared memory with one TMA
//     tensor copy and one mbarrier wait. Its origin (y0-2, x0-4) may lie
//     outside the image; TMA fills out-of-bounds elements with zeros, which
//     is the kernel's zero padding, so the load has no bounds checks. The
//     tensor map is 3-D, (W, H, B) with a box depth of 1: the rows above
//     and below an image are out of bounds of ITS plane and read as zeros,
//     where a 2-D map over the (B*H, W) stack would fill the halo with the
//     neighbouring image's rows. The
//     column origin is x0-4 and not x0-2 because the card refuses (illegal
//     instruction) a box whose innermost start coordinate is not a multiple
//     of 16 B; the 2 extra columns on each side are read and never used.
//     TMA also needs a 16-B aligned base and a row stride that is a
//     multiple of 16 B (W % 4 == 0). For any other input the same kernel
//     fills the same tile with coalesced per-thread loads (zeros outside
//     the image) and one barrier. The host picks the stage
//     (pvio_shi_tomasi_plan; the Python wrapper's launch_plan follows the
//     same rule).
//   * No intermediate passes through shared memory. Each thread walks down
//     its rows reading 8 values of each input row from the tile (float2,
//     float4, float2), keeps the horizontal differences and smoothings of
//     the last three input rows in registers (Scharr is separable), forms
//     the gradient products at its 6 product columns (the 2 neighbouring
//     ones computed again: taking them from the neighbouring lanes by
//     __shfl_sync measured slower), zeroes products at positions outside
//     the image, and keeps the horizontal 3-sums of the last three product
//     rows in registers for the vertical 3-sum.
//   * Stores are float4 when W % 4 == 0 and the output is 16-B aligned
//     (a warp writes 512 contiguous bytes of a row), scalar otherwise.
// The arithmetic is the image's type throughout: float32, or float64 for a
// float64 image (a float64 engine). The reference's TPU kernel computes in
// float32 whatever the engine's dtype; here a float32 response alone moved
// the card's 60 s float64 endurance run off the reference's outcome (fault
// F7), so a float64 image keeps the plain version's precision. The float64
// form keeps the tile, the box (30.5 KB of shared memory) and the plan; its
// loads are double2 (the 8 values of a row at 16-B aligned offsets) and its
// stores two double2 a thread row. TMA then needs rows that are a multiple
// of 16 B (W even). The gradient scale and the 1/9 box mean are applied
// once, to lambda_min (it is homogeneous of degree 1 in a, b, c).
//
// Plain C interface for ctypes:
//   pvio_shi_tomasi(in, out, B, H, W, stream) (float32) and
//   pvio_shi_tomasi_f64(in, out, B, H, W, stream) (float64) encode the
//     tensor map when TMA applies, launch once for the B images on `stream`
//     and return cudaGetLastError(), or the negated CUresult when the
//     tensor map cannot be encoded;
//   pvio_shi_tomasi_plan(H, W, in, elem, plan[7]) writes the launch plan for
//     elements of `elem` bytes (4 or 8): tile rows, tile columns, grid x,
//     grid y, 1 if the TMA stage loads the tile (else 0), box rows, box
//     columns.
// cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
// build needs nvcc alone and no -lcuda.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int TH = 24;                   // output rows per block
constexpr int TW = 128;                  // output columns per block
constexpr int RUN = 2;                   // output rows per thread
constexpr int BH = TH + 4, BW = TW + 8;  // input box: rows y0-2.., columns x0-4..
constexpr int TX = TW / 4, TY = TH / RUN;
static_assert(TW % 4 == 0 && TH % RUN == 0, "a thread owns 4 columns x RUN rows");
static_assert(BW <= 256 && BH <= 256 && (BW * 4) % 16 == 0, "TMA box limits");
static_assert(BH * BW * 8 <= 48 * 1024, "the float64 box fits static shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Scharr's 10/3: the gradients are kept as Scharr / 32 * (32 / 3), so that
// each 3-10-3 weighting is one add and one fma; the 9/1024 this leaves on
// the products and the box mean's 1/9 are taken out at the end.
template <typename T>
__device__ __forceinline__ T k10_3() {
  return T(10) / T(3);
}

// The 8 values of a row at r (r is 8-B aligned, r + 2 is 16-B aligned in
// shared memory; for float64 every even offset is).
__device__ __forceinline__ void load8(const float* r, float (&v)[8]) {
  const float2 a = *reinterpret_cast<const float2*>(r);
  const float4 b = *reinterpret_cast<const float4*>(r + 2);
  const float2 c = *reinterpret_cast<const float2*>(r + 6);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y; v[4] = b.z; v[5] = b.w; v[6] = c.x; v[7] = c.y;
}

__device__ __forceinline__ void load8(const double* r, double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 a = *reinterpret_cast<const double2*>(r + 2 * i);
    v[2 * i] = a.x;
    v[2 * i + 1] = a.y;
  }
}

// One input row as this thread needs it: r = 8 values at tile columns
// c0-2 .. c0+5. For each of the 6 product columns m (tile column c0-1+m) it
// keeps the horizontal difference r[m+2] - r[m] and the horizontal Scharr
// smoothing (3 r[m] + 10 r[m+1] + 3 r[m+2]) / 3.
template <typename T>
struct Row {
  T dx[6], sm[6];
};

template <typename T>
__device__ __forceinline__ void load_row(Row<T>& row, const T* r) {
  T v[8];
  load8(r, v);
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    row.dx[m] = v[m + 2] - v[m];
    row.sm[m] = (v[m] + v[m + 2]) + k10_3<T>() * v[m + 1];
  }
}

// The three gradient products at product column m from the last three
// input rows; zero when the position lies outside the image (`in` false).
template <typename T>
__device__ __forceinline__ void product(const Row<T>& up, const Row<T>& mid, const Row<T>& dn,
                                        int m, bool in, T& xx, T& xy, T& yy) {
  T gx = (up.dx[m] + dn.dx[m]) + k10_3<T>() * mid.dx[m];  // Scharr x * 32 / 3
  T gy = dn.sm[m] - up.sm[m];                              // Scharr y * 32 / 3
  if (!in) gx = gy = T(0);
  xx = gx * gx;
  xy = gx * gy;
  yy = gy * gy;
}

// h[e] = q[e] + q[e+1] + q[e+2]: the 3-sums centred on the 4 output columns
template <typename T>
__device__ __forceinline__ void hsum3(const T (&q)[6], T (&h)[4]) {
  const T q12 = q[1] + q[2], q34 = q[3] + q[4];
  h[0] = q[0] + q12;
  h[1] = q12 + q[3];
  h[2] = q[2] + q34;
  h[3] = q34 + q[5];
}

// lambda_min from the box sums: sqrtf takes a slow branch for arguments
// below 2^-101, and flat image regions give exact zeros; 1e-30 keeps every
// lane on the fast path and moves the response by at most 5e-19. float64
// clamps at 0, as the plain version does.
__device__ __forceinline__ float lambda_min(float a, float b, float c, float scale) {
  const float d = a - c;
  return scale * ((a + c) - sqrtf(fmaxf(fmaf(d, d, 4.0f * (b * b)), 1e-30f)));
}

__device__ __forceinline__ double lambda_min(double a, double b, double c, double scale) {
  const double d = a - c;
  return scale * ((a + c) - sqrt(fmax(fma(d, d, 4.0 * (b * b)), 0.0)));
}

__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* o, const double (&v)[4]) {
  reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
}

// The thread's RUN output rows x 4 columns from the tile in shared memory.
template <typename T>
__device__ __forceinline__ void respond(const T (&s)[BH][BW], T* __restrict__ out,
                                        int H, int W, int x0, int y0, int vec_store) {
  // output tile columns c0 .. c0+3, rows r0 .. r0+RUN-1; s[ly][lx] holds
  // tile row ly - 2, tile column lx - 4
  const int c0 = 4 * threadIdx.x, r0 = RUN * threadIdx.y;
  bool col_in[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int gx = x0 + c0 - 1 + m;
    col_in[m] = gx >= 0 && gx < W;
  }

  Row<T> rows[3];      // the last three input rows
  T hp[3][3][4];       // horizontal 3-sums of gx*gx, gx*gy, gy*gy, last three product rows
  load_row(rows[0], &s[r0][c0 + 2]);
  load_row(rows[1], &s[r0 + 1][c0 + 2]);

#pragma unroll
  for (int k = 0; k < RUN + 2; ++k) {
    // product row p = r0 - 1 + k (tile coordinates), from input rows
    // p - 1 .. p + 1 = s rows r0 + k .. r0 + k + 2
    load_row(rows[(k + 2) % 3], &s[r0 + k + 2][c0 + 2]);
    const Row<T>& up = rows[k % 3];
    const Row<T>& mid = rows[(k + 1) % 3];
    const Row<T>& dn = rows[(k + 2) % 3];
    const int gyp = y0 + r0 - 1 + k;
    const bool row_in = gyp >= 0 && gyp < H;
    T pxx[6], pxy[6], pyy[6];
#pragma unroll
    for (int m = 0; m < 6; ++m)
      product(up, mid, dn, m, row_in && col_in[m], pxx[m], pxy[m], pyy[m]);
    hsum3(pxx, hp[k % 3][0]);
    hsum3(pxy, hp[k % 3][1]);
    hsum3(pyy, hp[k % 3][2]);
    if (k < 2) continue;

    // output row r0 + k - 2 from product rows r0 + k - 3 .. r0 + k - 1
    const int gy = y0 + r0 + k - 2;
    if (gy >= H) continue;
    // lambda_min = ((a + c) - sqrt((a - c)^2 + 4 b^2)) / 2 with a, b, c the
    // box sums of the scaled products: 1/2 * (3/32)^2 * 1/9 at the end
    const T scale = T(1) / T(2048);
    T v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const T a = hp[0][0][e] + hp[1][0][e] + hp[2][0][e];
      const T b = hp[0][1][e] + hp[1][1][e] + hp[2][1][e];
      const T c = hp[0][2][e] + hp[1][2][e] + hp[2][2][e];
      v[e] = lambda_min(a, b, c, scale);
    }
    const int gx = x0 + c0;
    T* o = out + (size_t)gy * W + gx;
    if (vec_store) {
      if (gx < W) store4(o, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gx + e < W) o[e] = v[e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
shi_tomasi_kernel(const __grid_constant__ CUtensorMap map,
                  const T* __restrict__ img, T* __restrict__ out,
                  int H, int W, int use_tma, int vec_store) {
  // s[ly][lx] holds pixel (y0 + ly - 2, x0 + lx - 4) of image z, 0 outside it
  __shared__ alignas(128) T s[BH][BW];
  __shared__ alignas(8) uint64_t bar;

  const int tid = threadIdx.y * TX + threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, z = blockIdx.z;
  img += (size_t)z * H * W;
  out += (size_t)z * H * W;

  if (use_tma) {
    const uint32_t b = smem_u32(&bar);
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(b), "r"(BH * BW * (int)sizeof(T)) : "memory");
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3, %4}], [%5];"
          ::"r"(smem_u32(&s[0][0])), "l"(reinterpret_cast<uint64_t>(&map)),
          "r"(x0 - 4), "r"(y0 - 2), "r"(z), "r"(b) : "memory");
    }
    uint32_t done = 0;
    do {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
          " selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(b) : "memory");
    } while (!done);
  } else {
    for (int i = tid; i < BH * BW; i += TX * TY) {
      const int ly = i / BW, lx = i - ly * BW;
      const int gy = y0 + ly - 2, gx = x0 + lx - 4;
      s[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                      ? __ldg(img + (size_t)gy * W + gx)
                      : T(0);
    }
    __syncthreads();
  }

  respond(s, out, H, W, x0, y0, vec_store);
}

// TMA needs a 16-B aligned base and rows that are a multiple of 16 B
bool tma_applies(int W, const void* img, int elem) {
  return (W * elem) % 16 == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
}

PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
    }
  }
  return fn;
}

template <typename T>
int launch(const T* img, T* out, int B, int H, int W, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const bool tma = tma_applies(W, img, sizeof(T));
  if (tma) {
    const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T), (cuuint64_t)H * W * sizeof(T)};
    const cuuint32_t box[3] = {BW, BH, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(&map, sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              3, const_cast<T*>(img), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  const int vec_store = W % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  shi_tomasi_kernel<T><<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      map, img, out, H, W, tma ? 1 : 0, vec_store);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pvio_shi_tomasi_plan(int H, int W, const void* img, int elem, int* plan) {
  plan[0] = TH;
  plan[1] = TW;
  plan[2] = (W + TW - 1) / TW;
  plan[3] = (H + TH - 1) / TH;
  plan[4] = tma_applies(W, img, elem) ? 1 : 0;
  plan[5] = BH;
  plan[6] = BW;
  return 0;
}

extern "C" int pvio_shi_tomasi(const float* img, float* out, int B, int H, int W,
                               void* stream) {
  return launch(img, out, B, H, W, stream);
}

extern "C" int pvio_shi_tomasi_f64(const double* img, double* out, int B, int H, int W,
                                   void* stream) {
  return launch(img, out, B, H, W, stream);
}
