// Fused Shi-Tomasi (GFTT minimum-eigenvalue) corner response for Hopper.
//
// Replaces the Pallas TPU kernel pvio_tpu/ops/stencil.py:_shi_tomasi_kernel
// (entered through shi_tomasi_response_tpu). For an (H, W) float32 image:
//   gx, gy  = Scharr / 32 gradients of the zero-padded image,
//   a, b, c = 3x3 box means of gx*gx, gx*gy, gy*gy, where a product at a
//             position outside the image counts as 0,
//   out     = (a + c) / 2 - sqrt(((a - c) / 2)^2 + b^2).
// That is the plain version pvio_torch/frontend/detect.py::
// shi_tomasi_response over the WHOLE image: the TPU kernel's circular-shift
// garbage in the 2-px border does not exist here, and the interior is the
// same function.
//
// Bound: the kernel must read the image once and write the response once,
// 2 * H * W * 4 bytes -- about 2.9 MB at 480x752, i.e. about 0.86 us at
// the H100's 3.35 TB/s. Its ~50 flops a pixel (18 MFLOP) take ~0.27 us at
// 67 TFLOP/s of FP32, so bytes bound it. At this size a launch (a few us)
// costs more than either, so launch latency, not bytes, sets its time.
//
// Design: one block of 32x16 threads per 32x16 output tile. The block
// stages its (16+4) x (32+4) input tile with a 2-px halo in shared memory
// (zeros outside the image), forms the three gradient products on the
// (16+2) x (32+2) ring around the tile (zeros outside the image), takes the
// separable 3x3 box through shared memory and writes lambda_min. Every
// input pixel is read from device memory by at most a few neighbouring
// blocks (the halo), every output written once; f32 throughout.
//
// Plain C interface for ctypes: pvio_shi_tomasi(in, out, H, W, stream)
// launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;  // output tile width  (threads in x)
constexpr int TH = 16;  // output tile height (threads in y)

__global__ void __launch_bounds__(TW * TH)
shi_tomasi_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int H, int W) {
  __shared__ float s_img[TH + 4][TW + 4];   // input tile + 2-px halo
  __shared__ float s_p[3][TH + 2][TW + 2];  // gx*gx, gx*gy, gy*gy on the ring
  __shared__ float s_h[3][TH + 2][TW];      // horizontal 3-sums

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;

  // s_img[ly][lx] holds pixel (y0 + ly - 2, x0 + lx - 2)
  for (int i = tid; i < (TH + 4) * (TW + 4); i += TW * TH) {
    const int ly = i / (TW + 4), lx = i - ly * (TW + 4);
    const int gy = y0 + ly - 2, gx = x0 + lx - 2;
    s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? __ldg(img + (size_t)gy * W + gx)
                        : 0.0f;
  }
  __syncthreads();

  // ring position (ly, lx) is pixel (y0 + ly - 1, x0 + lx - 1), which sits
  // at s_img[ly + 1][lx + 1]
  for (int i = tid; i < (TH + 2) * (TW + 2); i += TW * TH) {
    const int ly = i / (TW + 2), lx = i - ly * (TW + 2);
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    float ix = 0.0f, iy = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int cy = ly + 1, cx = lx + 1;
      ix = (3.0f * (s_img[cy - 1][cx + 1] - s_img[cy - 1][cx - 1]) +
            10.0f * (s_img[cy][cx + 1] - s_img[cy][cx - 1]) +
            3.0f * (s_img[cy + 1][cx + 1] - s_img[cy + 1][cx - 1])) *
           (1.0f / 32.0f);
      iy = (3.0f * (s_img[cy + 1][cx - 1] - s_img[cy - 1][cx - 1]) +
            10.0f * (s_img[cy + 1][cx] - s_img[cy - 1][cx]) +
            3.0f * (s_img[cy + 1][cx + 1] - s_img[cy - 1][cx + 1])) *
           (1.0f / 32.0f);
    }
    s_p[0][ly][lx] = ix * ix;
    s_p[1][ly][lx] = ix * iy;
    s_p[2][ly][lx] = iy * iy;
  }
  __syncthreads();

  // s_h[k][ly][lx] = sum of ring columns lx .. lx + 2 (centred on output
  // column lx)
  for (int i = tid; i < (TH + 2) * TW; i += TW * TH) {
    const int ly = i / TW, lx = i - ly * TW;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_h[k][ly][lx] = s_p[k][ly][lx] + s_p[k][ly][lx + 1] + s_p[k][ly][lx + 2];
    }
  }
  __syncthreads();

  const int gx = x0 + tx, gy = y0 + ty;
  if (gx < W && gy < H) {
    const float ninth = 1.0f / 9.0f;
    const float a = (s_h[0][ty][tx] + s_h[0][ty + 1][tx] + s_h[0][ty + 2][tx]) * ninth;
    const float b = (s_h[1][ty][tx] + s_h[1][ty + 1][tx] + s_h[1][ty + 2][tx]) * ninth;
    const float c = (s_h[2][ty][tx] + s_h[2][ty + 1][tx] + s_h[2][ty + 2][tx]) * ninth;
    const float hd = 0.5f * (a - c);
    out[(size_t)gy * W + gx] = 0.5f * (a + c) - sqrtf(fmaxf(hd * hd + b * b, 0.0f));
  }
}

}  // namespace

extern "C" int pvio_shi_tomasi(const float* img, float* out, int H, int W,
                               void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  shi_tomasi_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, H, W);
  return (int)cudaGetLastError();
}
