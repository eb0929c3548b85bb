// Fused SPADE conditioning for Hopper (sm_90a), f32 or bf16 in, f32 sums.
//
// Replaces the Pallas TPU kernel climategan_tpu/ops/pallas/spade.py:spade_cond.
// For each branch b of a SPADE (one branch) or of the norm_s + norm_0 pair of
// a SPADE residual block (two branches, one concatenated mlp_shared):
//   a_b          = relu(conv3x3(seg, k1[..., slice_b]) + b1[slice_b])
//   [gamma|beta] = conv3x3(a_b, [kg|kb]) + [bg|bb]
// Both convs pad with zeros: activation pixels outside the image are 0, not
// relu(b1). The hid-channel activation never reaches device memory.
//
// Bound on an H100: operations. At the painter's shapes the second conv does
// 2 * 9 * hid * 2nc FLOP per pixel against 2 * 2nc output bytes (bf16), some
// 1,150 FLOP per byte, far above the card's ~295 FLOP/byte ridge.
//
// Design (the simple, correct first version; tensor cores come later):
//   * one block per (image, 8x16 output tile, branch, group of 64-channel
//     chunks of that branch's [gamma|beta]), 256 threads. A group is the
//     whole branch unless that leaves fewer than MIN_BLOCKS blocks: then the
//     groups are halved until the grid has enough blocks (or one chunk per
//     block), so the small low-resolution calls (5^2 .. 40^2 pixels at 640
//     channels) still fill the SMs. Each group recomputes the first conv,
//     which costs about a fifth of one chunk's second conv;
//   * the conditioning window with a 2-px halo is staged in shared memory,
//     zeros outside the image;
//   * each branch's activation over the tile plus a 1-px halo is computed into
//     dynamic shared memory, channel-major with a row stride of 20 floats so
//     the stage-2 reads of a warp hit 32 distinct banks; halo pixels outside
//     the image are set to 0;
//   * stage 2: warp w owns 8 output channels of a 64-channel chunk, lane l owns
//     4 output rows of one column; 32 f32 accumulators per thread, 6 shared
//     loads and 3 broadcast 8-wide weight loads (read-only cache) per 96 FMAs;
// Weights are pre-packed by the caller: w2 is (3, 3, hid, cpad) with the
// [gamma|beta] output channels zero-padded to a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;              // output tile rows
constexpr int TW = 16;             // output tile columns
constexpr int AH = TH + 2;         // activation window rows (1-px halo)
constexpr int AW = TW + 2;         // activation window columns
constexpr int ARS = 20;            // activation row stride in shared memory
constexpr int ACS = AH * ARS;      // activation channel stride
constexpr int SH = TH + 4;         // conditioning window rows (2-px halo)
constexpr int SW = TW + 4;         // conditioning window columns
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int CH_PER_THREAD = 8;
constexpr int CHUNK = (THREADS / 32) * CH_PER_THREAD;  // 64
constexpr int MAX_BRANCHES = 4;
constexpr int MIN_BLOCKS = 4 * 132;  // two waves of two blocks per SM

struct Branch {
  int hid;         // hidden channels of the branch
  int hid_off;     // first channel of the branch in the shared activation
  int cout;        // 2 * nc
  int cpad;        // cout rounded up to CHUNK
  const void* w2;  // (3, 3, hid, cpad)
  const void* b2;  // (cout,)
  void* out;       // (N, H, W, cout)
};

struct Params {
  const void* seg;  // (N, H, W, cnc)
  const void* k1;   // (3, 3, cnc, hid_total)
  const void* b1;   // (hid_total,)
  int N, H, W, cnc, hid_total, hid_max, nb;
  int group;        // 64-channel chunks per block
  int groups;       // blocks per (image, tile): sum over branches of
                    // ceil(cpad / CHUNK / group)
  Branch br[MAX_BRANCHES];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive weights; the packing keeps them 32-byte (f32) or 16-byte
// (bf16) aligned
__device__ __forceinline__ void load8(const float* p, float w[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float w[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
spade_cond_kernel(const Params p) {
  extern __shared__ float smem[];
  float* act = smem;                        // [hid][AH][ARS]
  float* segw = smem + p.hid_max * ACS;     // [SH][SW][cnc]

  const T* seg = static_cast<const T*>(p.seg);
  const T* k1 = static_cast<const T*>(p.k1);
  const T* b1 = static_cast<const T*>(p.b1);
  const int H = p.H, W = p.W, cnc = p.cnc;
  const int n = blockIdx.z / p.groups;
  int grp = blockIdx.z - n * p.groups;
  int b = 0;
  while (grp >= (p.br[b].cpad / CHUNK + p.group - 1) / p.group) {
    grp -= (p.br[b].cpad / CHUNK + p.group - 1) / p.group;
    ++b;
  }
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // conditioning window: element (i, j) is image pixel (y0-2+i, x0-2+j)
  for (int idx = tid; idx < SH * SW * cnc; idx += THREADS) {
    const int pix = idx / cnc;
    const int ci = idx - pix * cnc;
    const int y = y0 - 2 + pix / SW;
    const int x = x0 - 2 + pix % SW;
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      v = to_f(seg[((static_cast<size_t>(n) * H + y) * W + x) * cnc + ci]);
    }
    segw[idx] = v;
  }
  __syncthreads();

  const int hid = p.br[b].hid;
  const int hid_off = p.br[b].hid_off;
  const int cout = p.br[b].cout;
  const int cpad = p.br[b].cpad;
  const T* w2 = static_cast<const T*>(p.br[b].w2);
  const T* b2 = static_cast<const T*>(p.br[b].b2);
  T* out = static_cast<T*>(p.br[b].out);

  // stage 1: activation element (c, i, j) is image pixel (y0-1+i, x0-1+j)
  for (int idx = tid; idx < hid * AH * AW; idx += THREADS) {
    const int c = idx / (AH * AW);
    const int pix = idx - c * (AH * AW);
    const int i = pix / AW;
    const int j = pix - i * AW;
    const int y = y0 - 1 + i;
    const int x = x0 - 1 + j;
    float a = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float s = to_f(b1[hid_off + c]);
      for (int ky = 0; ky < 3; ++ky) {
        for (int kx = 0; kx < 3; ++kx) {
          const float* sp = segw + ((i + ky) * SW + (j + kx)) * cnc;
          const T* kp = k1 + (ky * 3 + kx) * cnc * p.hid_total + hid_off + c;
          for (int ci = 0; ci < cnc; ++ci) {
            s = fmaf(sp[ci], to_f(kp[ci * p.hid_total]), s);
          }
        }
      }
      a = fmaxf(s, 0.f);
    }
    act[c * ACS + i * ARS + j] = a;
  }
  __syncthreads();

  // stage 2: output pixels (y0 + r0 + r, x0 + col), r = 0..3, channels
  // oc .. oc+7 of each chunk of this block's group
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = lane & 15;
  const int r0 = (lane >> 4) * ROWS_PER_THREAD;
  const int c_end = min(cpad, (grp + 1) * p.group * CHUNK);
  for (int c0 = grp * p.group * CHUNK; c0 < c_end; c0 += CHUNK) {
    const int oc = c0 + warp * CH_PER_THREAD;
    float acc[ROWS_PER_THREAD][CH_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
#pragma unroll
      for (int q = 0; q < CH_PER_THREAD; ++q) acc[r][q] = 0.f;
    }
    for (int c = 0; c < hid; ++c) {
      const float* ac = act + c * ACS + r0 * ARS + col;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float a[ROWS_PER_THREAD + 2];
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD + 2; ++r) a[r] = ac[r * ARS + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float w[CH_PER_THREAD];
          load8(w2 + (static_cast<size_t>((ky * 3 + kx) * hid + c)) * cpad + oc,
                w);
#pragma unroll
          for (int r = 0; r < ROWS_PER_THREAD; ++r) {
#pragma unroll
            for (int q = 0; q < CH_PER_THREAD; ++q) {
              acc[r][q] = fmaf(a[r + ky], w[q], acc[r][q]);
            }
          }
        }
      }
    }
    const int x = x0 + col;
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int y = y0 + r0 + r;
      if (y < H && x < W) {
        T* o = out + ((static_cast<size_t>(n) * H + y) * W + x) * cout;
#pragma unroll
        for (int q = 0; q < CH_PER_THREAD; ++q) {
          if (oc + q < cout) o[oc + q] = from_f<T>(acc[r][q] + to_f(b2[oc + q]));
        }
      }
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(p.hid_max) * ACS + SH * SW * p.cnc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spade_cond_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, p.N * p.groups);
  spade_cond_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spade_cond_chunk() { return CHUNK; }

int spade_cond_max_branches() { return MAX_BRANCHES; }

// Shared memory one block needs, in bytes.
long long spade_cond_smem_bytes(int hid_max, int cnc) {
  return (static_cast<long long>(hid_max) * ACS + SH * SW * cnc) *
         static_cast<long long>(sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int spade_cond_launch(int dtype, const void* seg, const void* k1,
                      const void* b1, int N, int H, int W, int cnc,
                      int hid_total, int nb, const int* hids,
                      const int* couts, const int* cpads,
                      const void* const* w2s, const void* const* b2s,
                      void* const* outs, void* stream) {
  if (nb < 1 || nb > MAX_BRANCHES) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.seg = seg;
  p.k1 = k1;
  p.b1 = b1;
  p.N = N;
  p.H = H;
  p.W = W;
  p.cnc = cnc;
  p.hid_total = hid_total;
  p.nb = nb;
  p.hid_max = 0;
  int off = 0;
  int max_chunks = 0;
  for (int b = 0; b < nb; ++b) {
    if (cpads[b] % CHUNK != 0 || cpads[b] < couts[b]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.br[b].hid = hids[b];
    p.br[b].hid_off = off;
    p.br[b].cout = couts[b];
    p.br[b].cpad = cpads[b];
    p.br[b].w2 = w2s[b];
    p.br[b].b2 = b2s[b];
    p.br[b].out = outs[b];
    off += hids[b];
    if (hids[b] > p.hid_max) p.hid_max = hids[b];
    if (cpads[b] / CHUNK > max_chunks) max_chunks = cpads[b] / CHUNK;
  }
  if (off != hid_total) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(N) * ((H + TH - 1) / TH) *
                          ((W + TW - 1) / TW);
  p.group = max_chunks;
  for (;;) {
    p.groups = 0;
    for (int b = 0; b < nb; ++b) {
      p.groups += (cpads[b] / CHUNK + p.group - 1) / p.group;
    }
    if (p.group == 1 || tiles * p.groups >= MIN_BLOCKS) break;
    p.group = (p.group + 1) / 2;
  }
  if (static_cast<long long>(N) * p.groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* spade_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
