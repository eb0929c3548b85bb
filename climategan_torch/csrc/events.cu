// Elementwise kernels of the wildfire and smog events, for sm_90a.
//
// Replace the Pallas TPU kernels smog_tail, fire_color_grade and fire_paste
// of climategan_tpu/ops/pallas/events.py. Each is one streaming pass over
// float32 NCHW planes: x (N, 3, H, W), and for smog_tail and fire_paste one
// (N, 1, H, W) plane (depth or sky) that is read once per pixel and applied
// to the pixel's three channels. Their bound on an H100 is bytes (about 7
// planes of float32 per pass against a few dozen instructions per pixel).
//
// smog_tail and fire_color_grade are built for the memory system: a 640^2
// batch is only 20-23 MB, a few microseconds of HBM time, so what counts is
// how many bytes each SM keeps in flight. Each thread issues all of its
// loads as 16-byte vectors before any math (smog_tail: the depth and the
// three channels of 4 consecutive pixels; fire_color_grade: two runs of 4
// values), and stores 16 bytes at a time. The grid is sized to the card
// (SMs x resident blocks per SM, from the occupancy API, cached per device)
// and walks the data in a grid-stride loop on 64-bit indices; smog_tail
// divides out the image index once per run of 4 pixels. A scalar path in
// the same kernel takes what a vector cannot: H*W not a multiple of 4 or a
// base not 16-byte aligned (smog_tail, still 4 pixels a turn), a
// misaligned base or the last n % 4 values (fire_color_grade). fire_paste
// is still one thread per pixel.
//
// Rounding. The fire kernels floor twice, so every rounding is explicit
// (__fmul_rn, __fadd_rn, __fsub_rn) and in the JAX kernels' order: nvcc may
// not contract a multiply and an add into one FMA, and a blend lands on the
// same side of each floor step as the plain PyTorch versions in
// climategan_torch/kernels/, which run one rounded operation per kernel.
// smog_tail's output is not floored; it rounds explicitly only up to its
// last branch (linear -> sRGB at 0.0031308, where the curve steps by
// 2.5e-5), in the plain version's order on the card, so a value near that
// point takes the plain version's side. Its powers are 2^(k * log2(b)) on
// the hardware's base-2 log and exp (no powf; tests/test_torch_port_cuda.py
// sweeps the error over 2^20 inputs), and the rest may contract. No
// --use_fast_math for the file.
//
// Each launcher takes PyTorch's current stream and returns
// cudaGetLastError() of its launch, or the error of the call that sized
// its grid.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;
constexpr int kMaxDevices = 64;
constexpr float kInvGamma = static_cast<float>(1.0 / 2.4);
// x / 12.92 on the dark path as PyTorch's CUDA division by a scalar
// computes it, a multiply by the float reciprocal, so the linear value that
// reaches the encode's step equals the plain version's; kInv1055 feeds only
// the power path, which stays clear of that step
constexpr float kInv1292 = 1.0f / 12.92f;
constexpr float kInv1055 = 1.0f / 1.055f;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

using Index = unsigned long long;

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Blocks of kThreads for `work` threads' worth of work: at most one wave
// of the card (SMs x blocks of `kernel` resident per SM, asked once per
// device into `cache`), at least one block.
template <typename Kernel>
cudaError_t card_blocks(Kernel kernel, int* cache, long long work,
                        int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return e;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (work + kThreads - 1) / kThreads;
  *blocks = static_cast<int>(need < cache[dev] ? (need > 0 ? need : 1)
                                               : cache[dev]);
  return cudaSuccess;
}

__device__ __forceinline__ void st4(float4* p, float4 v) { *p = v; }

// torch.clamp(v, 0, 255) (a NaN stays NaN), then floor: uint8 truncation
__device__ __forceinline__ float quantize_u8(float v) {
  return floorf(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
}

// ---- smog_tail --------------------------------------------------------

struct SmogParams {
  float neg_beta, airlight, keep, tint[3];
};

// The hardware's base-2 exp and log (MUFU.EX2, MUFU.LG2), subnormals
// flushed: every argument and result that smog_tail keeps is a normal float
// (the log's argument is at least 1e-12 or 0.0904, the exp's result at
// least 1e-5), so the flush costs nothing and saves the scaling steps that
// exp2f and __log2f add around the same instructions.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Both sides, then a select, as the JAX kernel's jnp.where: no branch
__device__ __forceinline__ float srgb_to_linear(float x) {
  const float hi = ex2(2.4f * lg2((x + 0.055f) * kInv1055));
  return x <= 0.04045f ? x * kInv1292 : hi;
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  const float base = x < 1e-12f ? 1e-12f : x;  // torch.clamp: NaN stays NaN
  const float hi = 1.055f * ex2(lg2(base) * kInvGamma) - 0.055f;
  return x <= 0.0031308f ? 12.92f * x : hi;
}

// sRGB -> linear, t * lin + haze, linear -> sRGB, then * keep + tint
__device__ __forceinline__ float smog_value(float x, float t, float haze,
                                            float keep, float tint) {
  const float sm = __fadd_rn(__fmul_rn(t, srgb_to_linear(x)), haze);
  return linear_to_srgb(sm) * keep + tint;
}

// t = exp(-beta * d), haze = (1 - t) * airlight; keep = 1 - alpha/255,
// tint_c = yellow_c/255 * alpha/255; the three channels in place.
__device__ __forceinline__ void smog_pixel(float d, float& r, float& g,
                                           float& b, const SmogParams& p) {
  const float t = expf(d * p.neg_beta);
  const float haze = __fmul_rn(__fsub_rn(1.f, t), p.airlight);
  r = smog_value(r, t, haze, p.keep, p.tint[0]);
  g = smog_value(g, t, haze, p.keep, p.tint[1]);
  b = smog_value(b, t, haze, p.keep, p.tint[2]);
}

__device__ __forceinline__ void smog_quad(float4 d, float4& r, float4& g,
                                          float4& b, const SmogParams& p) {
  smog_pixel(d.x, r.x, g.x, b.x, p);
  smog_pixel(d.y, r.y, g.y, b.y, p);
  smog_pixel(d.z, r.z, g.z, b.z, p);
  smog_pixel(d.w, r.w, g.w, b.w, p);
}

// A thread takes a run of 4 consecutive pixels per turn and divides out
// their image index once. vec: H*W % 4 == 0 and x, d, out 16-byte aligned,
// so the run lies in one image and its four loads are float4s, all issued
// first. Otherwise the run's pixels go one by one and may cross into the
// next image (at most one step a pixel, as H*W >= 1).
__global__ void __launch_bounds__(kThreads)
    smog_tail_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     float* __restrict__ out, Index px, Index hw, bool vec,
                     SmogParams p) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  const Index tid = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    const float4* __restrict__ d4 = reinterpret_cast<const float4*>(d);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
    const Index hw4 = hw / 4, quads = px / 4;
    for (Index q = tid; q < quads; q += stride) {
      const Index i = q + 2 * (q / hw4) * hw4;  // image n's channel 0
      const float4 dv = __ldg(d4 + q);
      float4 r = __ldg(x4 + i), g = __ldg(x4 + i + hw4),
             b = __ldg(x4 + i + 2 * hw4);
      smog_quad(dv, r, g, b, p);
      st4(o4 + i, r);
      st4(o4 + i + hw4, g);
      st4(o4 + i + 2 * hw4, b);
    }
    return;
  }
  for (Index q = tid; 4 * q < px; q += stride) {
    Index j = 4 * q, n = j / hw, next = (n + 1) * hw;
    for (int k = 0; k < 4 && j < px; ++k, ++j) {
      if (j == next) {
        ++n;
        next += hw;
      }
      const Index i = j + 2 * n * hw;
      float r = x[i], g = x[i + hw], b = x[i + 2 * hw];
      smog_pixel(d[j], r, g, b, p);
      out[i] = r;
      out[i + hw] = g;
      out[i + 2 * hw] = b;
    }
  }
}

// ---- fire_color_grade -------------------------------------------------

// floor(clip(contrast * x + (1 - contrast) * mean)), then
// floor(clip(brightness * v)); shift = (1 - contrast) * mean.
__device__ __forceinline__ float grade(float x, float contrast, float shift,
                                       float brightness) {
  const float v = quantize_u8(__fadd_rn(__fmul_rn(contrast, x), shift));
  return quantize_u8(__fmul_rn(brightness, v));
}

__device__ __forceinline__ float4 grade4(float4 v, float contrast,
                                         float shift, float brightness) {
  return make_float4(grade(v.x, contrast, shift, brightness),
                     grade(v.y, contrast, shift, brightness),
                     grade(v.z, contrast, shift, brightness),
                     grade(v.w, contrast, shift, brightness));
}

// *mean is the whole batch's gray mean, read once per thread. vec: x and
// out 16-byte aligned; a thread takes two runs of 4 values per turn, one
// wave apart (both loads first), then the last n % 4 values go one by one.
// Otherwise every value goes one by one.
__global__ void __launch_bounds__(kThreads)
    fire_color_grade_kernel(const float* __restrict__ x,
                            const float* __restrict__ mean,
                            float* __restrict__ out, Index n, bool vec,
                            float contrast, float one_minus_contrast,
                            float brightness) {
  const float shift = __fmul_rn(one_minus_contrast, *mean);
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  const Index tid = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  Index head = 0;
  if (vec) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
    const Index n4 = n / 4;
    for (Index f = tid; f < n4; f += 2 * stride) {
      const Index f2 = f + stride;
      const bool two = f2 < n4;
      const float4 a = __ldg(x4 + f);
      const float4 b = two ? __ldg(x4 + f2) : a;
      st4(o4 + f, grade4(a, contrast, shift, brightness));
      if (two) st4(o4 + f2, grade4(b, contrast, shift, brightness));
    }
    head = n4 * 4;
  }
  for (Index i = head + tid; i < n; i += stride)
    out[i] = grade(x[i], contrast, shift, brightness);
}

// ---- fire_paste -------------------------------------------------------

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
  if (px <= 0) return static_cast<int>(cudaGetLastError());
  static int cache[kMaxDevices];
  const bool vec =
      hw % 4 == 0 && aligned16(x) && aligned16(d) && aligned16(out);
  int blocks = 0;
  const cudaError_t e =
      card_blocks(smog_tail_kernel, cache, (px + 3) / 4, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  smog_tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, d, out, px, hw, vec,
      SmogParams{neg_beta, airlight, keep, {tint0, tint1, tint2}});
  return static_cast<int>(cudaGetLastError());
}

// x, out: n float32 values; mean: one float32 on the device.
int fire_color_grade_launch(const float* x, const float* mean, float* out,
                            long long n, float contrast,
                            float one_minus_contrast, float brightness,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  static int cache[kMaxDevices];
  const bool vec = aligned16(x) && aligned16(out);
  int blocks = 0;
  const cudaError_t e = card_blocks(fire_color_grade_kernel, cache,
                                    vec ? (n / 4 + 1) / 2 : n, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  fire_color_grade_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, mean, out, n, vec, contrast, one_minus_contrast, brightness);
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
