// Elementwise kernels of the wildfire and smog events, for sm_90a.
//
// Replace the Pallas TPU kernels smog_tail, fire_color_grade and fire_paste
// of climategan_tpu/ops/pallas/events.py. Each is one streaming pass over
// float32 NCHW planes: x (N, 3, H, W), and for smog_tail and fire_paste one
// (N, 1, H, W) plane (depth or sky) that is read once per pixel and applied
// to the pixel's three channels. Their bound on an H100 is bytes (about 7
// planes of float32 per pass against a handful of operations per value), so
// the design is one thread per value or pixel in a grid-stride loop, with
// neighbouring threads on neighbouring addresses.
//
// Every rounding is explicit (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn)
// and in the JAX kernels' order, and expf/powf are the accurate library
// functions (no --use_fast_math): nvcc may not contract a multiply and an
// add into one FMA, so a blend lands on the same side of each floor step as
// the plain PyTorch versions in climategan_torch/kernels/, which run one
// rounded operation per kernel.
//
// Each launcher takes PyTorch's current stream and returns
// cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;
constexpr float kInvGamma = static_cast<float>(1.0 / 2.4);

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// torch.clamp(v, 0, 255) (a NaN stays NaN), then floor: uint8 truncation
__device__ __forceinline__ float quantize_u8(float v) {
  return floorf(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
}

__device__ __forceinline__ float srgb_to_linear(float x) {
  if (x <= 0.04045f) return __fdiv_rn(x, 12.92f);
  return powf(__fdiv_rn(__fadd_rn(x, 0.055f), 1.055f), 2.4f);
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  if (x <= 0.0031308f) return __fmul_rn(12.92f, x);
  const float base = x < 1e-12f ? 1e-12f : x;  // torch.clamp: NaN stays NaN
  return __fsub_rn(__fmul_rn(1.055f, powf(base, kInvGamma)), 0.055f);
}

// t = exp(-beta * d); per channel: sRGB -> linear, t * lin + (1 - t) *
// airlight, linear -> sRGB, then lin * keep + tint_c (keep = 1 - alpha/255,
// tint_c = yellow_c/255 * alpha/255).
__global__ void smog_tail_kernel(const float* __restrict__ x,
                                 const float* __restrict__ d,
                                 float* __restrict__ out, long long px,
                                 long long hw, float neg_beta, float airlight,
                                 float keep, float tint0, float tint1,
                                 float tint2) {
  const float tint[3] = {tint0, tint1, tint2};
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < px; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long n = p / hw;
    const long long base = p + 2 * n * hw;  // (n * 3) * hw + (p - n * hw)
    const float t = expf(__fmul_rn(d[p], neg_beta));
    const float haze = __fmul_rn(__fsub_rn(1.f, t), airlight);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lin = srgb_to_linear(x[base + c * hw]);
      const float sm = linear_to_srgb(__fadd_rn(__fmul_rn(t, lin), haze));
      out[base + c * hw] = __fadd_rn(__fmul_rn(sm, keep), tint[c]);
    }
  }
}

// floor(clip(contrast * x + (1 - contrast) * mean)), then
// floor(clip(brightness * v)); *mean is the whole batch's gray mean.
__global__ void fire_color_grade_kernel(const float* __restrict__ x,
                                        const float* __restrict__ mean,
                                        float* __restrict__ out, long long n,
                                        float contrast, float one_minus_contrast,
                                        float brightness) {
  const float shift = __fmul_rn(one_minus_contrast, *mean);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = quantize_u8(__fadd_rn(__fmul_rn(contrast, x[i]), shift));
    out[i] = quantize_u8(__fmul_rn(brightness, v));
  }
}

// m = transparency * sky; per channel v = m * f_c + (1 - m) * x_c with
// f = (255, *g, 0); floor(clip(v)), then floor(clip(brightness * v)).
__global__ void fire_paste_kernel(const float* __restrict__ x,
                                  const float* __restrict__ sky,
                                  const float* __restrict__ g,
                                  float* __restrict__ out, long long px,
                                  long long hw, float transparency,
                                  float brightness) {
  const float filt[3] = {255.f, *g, 0.f};
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < px; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long n = p / hw;
    const long long base = p + 2 * n * hw;
    const float m = __fmul_rn(transparency, sky[p]);
    const float keep = __fsub_rn(1.f, m);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = quantize_u8(
          __fadd_rn(__fmul_rn(m, filt[c]), __fmul_rn(keep, x[base + c * hw])));
      out[base + c * hw] = quantize_u8(__fmul_rn(brightness, v));
    }
  }
}

}  // namespace

extern "C" {

// x, out: (N, 3, H, W); d: (N, 1, H, W); px = N * H * W, hw = H * W.
int smog_tail_launch(const float* x, const float* d, float* out, long long px,
                     long long hw, float neg_beta, float airlight, float keep,
                     float tint0, float tint1, float tint2, void* stream) {
  if (px > 0)
    smog_tail_kernel<<<blocks_for(px), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, d, out, px, hw, neg_beta, airlight, keep, tint0, tint1, tint2);
  return static_cast<int>(cudaGetLastError());
}

// x, out: n float32 values; mean: one float32 on the device.
int fire_color_grade_launch(const float* x, const float* mean, float* out,
                            long long n, float contrast,
                            float one_minus_contrast, float brightness,
                            void* stream) {
  if (n > 0)
    fire_color_grade_kernel<<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, mean, out, n, contrast, one_minus_contrast, brightness);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (N, 3, H, W); sky: (N, 1, H, W); g: one float32 on the device.
int fire_paste_launch(const float* x, const float* sky, const float* g,
                      float* out, long long px, long long hw,
                      float transparency, float brightness, void* stream) {
  if (px > 0)
    fire_paste_kernel<<<blocks_for(px), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, sky, g, out, px, hw, transparency, brightness);
  return static_cast<int>(cudaGetLastError());
}

const char* events_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
