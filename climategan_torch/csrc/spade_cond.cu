// Fused SPADE conditioning for Hopper (sm_90a): two kernels, one per dtype.
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
// bf16 (spade_cond_tc_kernel, below): both convs on the tensor cores, the
// activation rounded to bf16 before the second, as the JAX kernel does.
// f32 (spade_cond_kernel): the CUDA-core kernel of the port's first version,
// kept as the correctness path; TF32's 10-bit mantissa would not hold the
// f32 bars (1e-4 against the plain version), and the f32 path is not timed.
//
// f32 design (the simple, correct first version):
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
//
// bf16 design (tensor cores), one block of 256 threads (two warpgroups) per
// (image, 8x16 output tile, branch, group of NT-wide chunks of [gamma|beta]),
// two blocks resident on each SM at CPT = 8 (about 110 KB of shared memory
// each; at CPT = 16 a block takes about 131 KB at hid 128, so one fits):
//   * the 12x20 conditioning window is loaded with zeros outside the image
//     at a row pitch of 24 pixels, CPT channels per pixel (a template
//     parameter): CPT = 8 for cnc <= 8 (the painter, cnc 3), 16 bytes per
//     pixel; CPT = 16 for 8 < cnc <= 16 (the SPADE mask decoder, cnc 12 or
//     15), 32 bytes per pixel as two planes of 16 (channels 0-7, then 8-15);
//     channels past cnc are zero;
//   * stage 1, wgmma m64n16k16 from shared memory, with no im2col: a 64-row
//     m tile is 64 consecutive pixels of the activation window laid out 24
//     wide, so 8 rows are 8 consecutive window pixels (one core matrix) and
//     each tap's A is the window shifted by the tap. At CPT = 8 a k16 step
//     pairs two taps, the leading byte offset being their distance, and B is
//     w1 as (10 taps, hid_pad, 8 channels), tap 9 zero (K = 80); at CPT = 16
//     a k16 step is one tap, its two halves the two planes, and B is w1 as
//     (9 taps, 2 halves, hid_pad, 8 channels) (K = 144). w1 is brought in by
//     one cp.async.bulk.
//     Warpgroup g computes half of the hidden channels over four m tiles.
//     The epilogue adds b1, applies relu, zeroes the pixels outside the image
//     and stores the 10x18 bf16 activation channel-chunk-major,
//     (hid / 8) x 180 pixels x 16 bytes;
//   * stage 2, wgmma m64nNTk16 with both operands from shared memory:
//     warpgroup g owns the 8x8 output patch at tile columns 8g..8g+7. In the
//     activation's layout 8 consecutive pixels of a window row are one 8x8
//     core matrix, so for tap (ky, kx) the A descriptor simply starts at
//     window pixel (ky, 8g + kx), with the next image row AW pixels on: the
//     3x3 im2col costs nothing and the activation is stored once. B streams
//     through a ring of four slabs of 80 hid bytes each (a whole tap at
//     NT = 40, half a tap at NT = 80) by cp.async.bulk with an mbarrier per
//     slot; a slot is refilled once both warpgroups' products on it are done
//     (wgmma.wait_group 1, then a block barrier), three slabs ahead. N = NT is
//     40 or 80 (40 when every branch has 2nc <= 40), so the painter's 640^2
//     calls (2nc = 40 and 80) run unpadded; wider branches run as chunks.
//     HS = hid_pad / 32 is a template parameter, so a slab's products are one
//     unrolled run of wgmma;
//   * epilogue: + b2 in f32, one bf16 rounding, stores of bf16 pairs;
//   * grid: the wrapper picks how many chunks a block takes (`group`): all
//     of its branch's chunks unless that leaves fewer than two blocks per SM,
//     then as few as needed (kernels/spade_cond.py:plan_groups). Each block
//     recomputes stage 1: 256 x 80 x hid products against the 128 x 9 hid x
//     NT of one chunk's stage 2 (44% at NT = 40, 22% at NT = 80).
// The weights are packed once per module (kernels/spade_cond.py:pack_spade_cond):
//   w1 per branch (10, hid_pad, 8) or (9, 2, hid_pad, 8), b1 f32 (sum
//   hid_pad); per branch w2
//   as (chunk, tap, ks, NT/8, 2, 8, 8): 8x8 core matrices, K-major, no
//   swizzle, so each slab of the ring is contiguous; b2 f32 (chunks * NT).
// Limits (the wrapper raises before launch): cnc <= 16, one hid per launch
// padded to at most 128, shared memory within the block limit.

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

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// 8 consecutive weights; the packing keeps them 32-byte aligned
__device__ __forceinline__ void load8(const float* p, float w[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
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

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int TC_THREADS = 256;                  // two warpgroups
constexpr int P_ACT = AH * AW;                   // 180 activation pixels
constexpr int TC_STAGES = 4;                     // slots of the weight ring
constexpr int WP = 24;                           // window row pitch, pixels
constexpr int S1_TILES = (AH * WP + 63) / 64;    // stage-1 m tiles: 4
// window pixels: every stage-1 row reads its tap's pixel, up to 2 rows and
// 2 pixels on
constexpr int W_PIX = (S1_TILES * 64 + 2 * WP + 2 + 7) / 8 * 8;
// stage-1 K per hidden channel: 9 taps (and a zero one) x 8 channels, or 9
// taps x 16 channels
template <int CPT>
__host__ __device__ constexpr int k1_of() { return CPT == 8 ? 10 * 8 : 9 * 16; }

struct TcBranch {
  int hid_off;   // first row of the branch in w1 and b1
  int cout;      // 2 * nc
  int chunks;    // NT-wide chunks of [gamma|beta], the last zero-padded
  const __nv_bfloat16* w2;
  const float* b2;
  __nv_bfloat16* out;
};

struct TcParams {
  const __nv_bfloat16* seg;  // (N, H, W, cnc)
  const __nv_bfloat16* w1;   // per branch (10 taps, hid_pad, 8 channels)
  const float* b1;           // (sum hid_pad,)
  int N, H, W, cnc, nb, group, groups;
  // bytes into shared memory; the ring is at 0
  int act_off, win_off, w1_off, bar_off;
  TcBranch br[MAX_BRANCHES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// a copy that never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int i = 0; !mbar_try(bar, parity); ++i) {
    if (i == (1 << 22)) __trap();
  }
}

// one contiguous slab of weights into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's fence and wait
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptors, no swizzle, K-major 8x8 core matrices of 8 rows x 16 B:
// the leading byte offset steps to the next 8 k, the stride byte offset to
// the next 8 rows (m or n).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
// B, the packed weights: core matrices (n group, k half) at 256 B and 128 B
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return desc(addr, 128, 256);
}
// A, the activation: channel chunk c of pixel q at (c * P_ACT + q) * 16 B,
// so 8 consecutive pixels of a window row are one core matrix, the next 8 k
// are P_ACT * 16 B on, and the next row group (image row) AW * 16 B on
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return desc(addr, P_ACT * 16, AW * 16);
}

// D(64 x NT, f32) (+)= A(64 x 16, bf16) * B(16 x NT, bf16), both from shared
// memory; D is overwritten where `accumulate` is 0
template <int NT>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void fma(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<40> {
  __device__ __forceinline__ static void fma(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
        "%20, %21, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void fma(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "%40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// NT: the chunk width; HS = hid_pad / 32, the k16 steps of one slab, fixed
// at compile time so that the stage-2 products of a slab are one unrolled
// run of wgmma; CPT: conditioning channels per window pixel (8 or 16)
template <int NT, int HS, int CPT>
__global__ void __launch_bounds__(TC_THREADS, 2)
spade_cond_tc_kernel(const TcParams p) {
  constexpr int K1 = k1_of<CPT>();
  constexpr int PLANES = CPT / 8;
  // a slab of the ring is 40 hp / NT rows of K by NT (80 hp bytes): a whole
  // tap at NT = 40, half a tap at NT = 80; KPS k16 steps, SPC per chunk
  constexpr int KPS = HS * 80 / NT;
  constexpr int SPC = 9 * NT / 40;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, W = p.W, cnc = p.cnc;
  const int n = blockIdx.z / p.groups;
  int grp = blockIdx.z - n * p.groups;
  int b = 0;
  while (grp >= (p.br[b].chunks + p.group - 1) / p.group) {
    grp -= (p.br[b].chunks + p.group - 1) / p.group;
    ++b;
  }
  const int hp = 32 * HS;
  const int cout = p.br[b].cout;
  const int c_begin = grp * p.group;
  const int n_slabs = (min(p.br[b].chunks, c_begin + p.group) - c_begin) * SPC;
  const int slab_elems = KPS * 16 * NT;
  const uint32_t slab = slab_elems * 2;
  const __nv_bfloat16* w2 = p.br[b].w2 + static_cast<size_t>(c_begin) * 9 * hp * NT;
  const float* b2 = p.br[b].b2;
  __nv_bfloat16* out = p.br[b].out;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  const uint32_t ring = smem_u32(tc_smem);
  const uint32_t act = smem_u32(tc_smem + p.act_off);
  unsigned char* act_p = tc_smem + p.act_off;
  const uint32_t win = smem_u32(tc_smem + p.win_off);
  const uint32_t w1s = smem_u32(tc_smem + p.w1_off);
  const uint32_t bars = smem_u32(tc_smem + p.bar_off);

  // the stage-1 weights and the first slabs of the stage-2 weights load
  // while the window is built
  if (tid == 0) {
    for (int s = 0; s <= TC_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(w1s, p.w1 + static_cast<size_t>(p.br[b].hid_off) * K1, hp * K1 * 2,
              bars + 8 * TC_STAGES);
    for (int s = 0; s < TC_STAGES && s < n_slabs; ++s) {
      bulk_load(ring + s * slab, w2 + static_cast<size_t>(s) * slab_elems, slab,
                bars + 8 * s);
    }
  }

  // conditioning window: plane k holds channels 8k .. 8k + 7 (zero past
  // cnc), 16 bytes per pixel; pixel w = i * WP + j is image pixel
  // (y0 - 2 + i, x0 - 2 + j) for i < SH, j < SW, zeros elsewhere and
  // outside the image
  for (int w = tid; w < W_PIX; w += TC_THREADS) {
    const int i = w / WP, j = w - (w / WP) * WP;
    const int y = y0 - 2 + i, x = x0 - 2 + j;
    uint32_t v[2 * CPT / 4] = {};
    if (i < SH && j < SW && y >= 0 && y < H && x >= 0 && x < W) {
      const __nv_bfloat16* src = p.seg + ((static_cast<size_t>(n) * H + y) * W + x) * cnc;
#pragma unroll
      for (int ci = 0; ci < CPT; ++ci) {
        if (ci < cnc) v[ci / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(src[ci]))
                                   << (16 * (ci % 2));
      }
    }
#pragma unroll
    for (int k = 0; k < PLANES; ++k) {
      *reinterpret_cast<uint4*>(tc_smem + p.win_off + (k * W_PIX + w) * 16) =
          make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // stage 1, wgmma m64n16k16 from shared memory, no im2col: row m of m tile
  // mt is activation pixel r = m' / WP, c = m' % WP (m' = 64 mt + m) of a
  // window WP pixels wide, so 8 consecutive rows are 8 consecutive window
  // pixels, one core matrix. At CPT = 8, k16 step s pairs taps 2s and 2s + 1
  // (tap 9 has zero weights), each 8 channels at the window pixel shifted by
  // the tap, the pair's distance being the leading byte offset; at CPT = 16,
  // k16 step s is tap s, its halves the two planes (W_PIX * 16 bytes
  // apart). In both, B's k halves are hp * 16 bytes apart. Warpgroup wg computes
  // hidden channels [wg hp / 2, (wg + 1) hp / 2) as HS chunks of 16. The
  // epilogue keeps r < AH, c < AW: activation (q = r AW + c, ch) =
  // relu(sum + b1[ch]), 0 outside the image, as bf16 at byte
  // ((ch / 8) * P_ACT + q) * 16 + 2 (ch % 8)
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float* b1 = p.b1 + p.br[b].hid_off;
  mbar_wait(bars + 8 * TC_STAGES, 0);
  for (int mt = 0; mt < S1_TILES; ++mt) {
    float d1[HS][8];
    wg_fence();
#pragma unroll
    for (int j = 0; j < HS; ++j) {
#pragma unroll
      for (int s = 0; s < K1 / 16; ++s) {
        uint64_t da;
        if constexpr (CPT == 8) {
          const int t0 = 2 * s, t1 = s < 4 ? 2 * s + 1 : 2 * s;
          const int sh0 = (t0 / 3) * WP + t0 % 3, sh1 = (t1 / 3) * WP + t1 % 3;
          da = desc(win + (mt * 64 + sh0) * 16, (sh1 - sh0) * 16 + (s < 4 ? 0 : 16), 128);
        } else {
          da = desc(win + (mt * 64 + (s / 3) * WP + s % 3) * 16, W_PIX * 16, 128);
        }
        Wgmma<16>::fma(d1[j], da,
                       desc(w1s + (2 * s * hp + (wg * HS + j) * 16) * 16, hp * 16, 128),
                       s);
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < HS; ++j) fence_acc<8>(d1[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 64 + wq * 16 + g + 8 * h;
      const int r = m / WP, c = m - (m / WP) * WP;
      const int y = y0 - 1 + r, x = x0 - 1 + c;
      if (r < AH && c < AW) {
        const int q = r * AW + c;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
        for (int j = 0; j < HS; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ch = (wg * HS + j) * 16 + 8 * i + 2 * t;
            const float v0 = in ? fmaxf(d1[j][4 * i + 2 * h] + b1[ch], 0.f) : 0.f;
            const float v1 = in ? fmaxf(d1[j][4 * i + 2 * h + 1] + b1[ch + 1], 0.f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(
                act_p + ((ch >> 3) * P_ACT + q) * 16 + (ch & 7) * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  // the activation was written by the generic proxy; wgmma reads it by the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // stage 2, wgmma: warpgroup wg computes the 8x8 output patch at tile
  // columns 8 wg .. 8 wg + 7 (its 64 rows are 8 image rows of 8 pixels);
  // for tap (ky, kx) its A tile starts at window pixel (ky, 8 wg + kx)
  float acc[NT / 2];
  for (int it = 0; it < n_slabs; ++it) {
    const int sc = it % SPC;  // slab of the chunk
    const int tap = sc / (SPC / 9);
    const int slot = it % TC_STAGES;
    mbar_wait(bars + 8 * slot, (it / TC_STAGES) & 1);
    const int ky = tap / 3, kx = tap - ky * 3;
    const uint32_t a0 = act + (ky * AW + kx + 8 * wg) * 16 +
                        (sc % (SPC / 9)) * KPS * 2 * P_ACT * 16;
    const uint32_t b0 = ring + slot * slab;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KPS; ++ks) {
      Wgmma<NT>::fma(acc, a_desc(a0 + ks * 2 * P_ACT * 16),
                     b_desc(b0 + ks * NT * 32), sc | ks);
    }
    wg_commit();
    if (sc == SPC - 1) {
      wg_wait<0>();
      fence_acc<NT / 2>(acc);  // the epilogue below reads the sums
    } else {
      wg_wait<1>();  // the previous slab's products are done
    }
    __syncthreads();  // every warpgroup is done with the previous slab
    if (tid == 0 && it >= 1 && it - 1 + TC_STAGES < n_slabs) {
      const int s = (it - 1) % TC_STAGES;
      bulk_load(ring + s * slab,
                w2 + static_cast<size_t>(it - 1 + TC_STAGES) * slab_elems,
                slab, bars + 8 * s);
    }
    if (sc == SPC - 1) {
      // d[4i + 2h + e] is pixel (2 wq + h, 8 wg + g), channel 8i + 2t + e
      // of the chunk
      const int c0 = (c_begin + it / SPC) * NT;
      const int x = x0 + 8 * wg + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = y0 + 2 * wq + h;
        if (y < H && x < W) {
          __nv_bfloat16* o = out + ((static_cast<size_t>(n) * H + y) * W + x) * cout;
#pragma unroll
          for (int i = 0; i < NT / 8; ++i) {
            const int c = c0 + 8 * i + 2 * t;
            if (c < cout) {
              *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(
                  acc[4 * i + 2 * h] + b2[c], acc[4 * i + 2 * h + 1] + b2[c + 1]);
            }
          }
        }
      }
    }
  }
}

struct TcLayout {
  int act_off, win_off, w1_off, bar_off, total;
};

TcLayout tc_layout(int hid_pad_max, int nt, int cpt) {
  TcLayout l;
  l.act_off = TC_STAGES * 80 * hid_pad_max;  // TC_STAGES slabs of 80 hp bytes
  l.win_off = l.act_off + (hid_pad_max / 8) * P_ACT * 16;
  l.w1_off = l.win_off + W_PIX * 16 * (cpt / 8);
  l.bar_off = l.w1_off + hid_pad_max * (cpt == 8 ? k1_of<8>() : k1_of<16>()) * 2;
  l.total = l.bar_off + (TC_STAGES + 1) * 8;
  return l;
}

template <int NT, int HS, int CPT>
int launch_tc(const TcParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(spade_cond_tc_kernel<NT, HS, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, p.N * p.groups);
  spade_cond_tc_kernel<NT, HS, CPT><<<grid, TC_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int CPT>
int launch_tc_hs(const TcParams& p, int hs, int smem, cudaStream_t stream) {
  switch (hs) {
    case 1: return launch_tc<NT, 1, CPT>(p, smem, stream);
    case 2: return launch_tc<NT, 2, CPT>(p, smem, stream);
    case 3: return launch_tc<NT, 3, CPT>(p, smem, stream);
    case 4: return launch_tc<NT, 4, CPT>(p, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
long long spade_cond_smem_bytes(int hid_max, int cnc) {
  return (static_cast<long long>(hid_max) * ACS + SH * SW * cnc) *
         static_cast<long long>(sizeof(float));
}

// The f32 CUDA-core kernel (bf16 takes the tensor-core kernel below).
// Returns a cudaError_t (0 on success).
int spade_cond_launch(const void* seg, const void* k1,
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
  return launch<float>(p, static_cast<cudaStream_t>(stream));
}

// Shared memory one block of the bf16 kernel needs, in bytes.
long long spade_cond_tc_smem_bytes(int hid_pad_max, int nt, int cnc) {
  return tc_layout(hid_pad_max, nt, cnc <= 8 ? 8 : 16).total;
}

// The bf16 tensor-core kernel on packed weights (see the notes at the top).
// group: chunks per block. Returns a cudaError_t (0 on success).
int spade_cond_tc_launch(const void* seg, const void* w1, const void* b1,
                         int N, int H, int W, int cnc, int nt,
                         int nb, const int* hid_pads, const int* couts,
                         const int* chunks, const void* const* w2s,
                         const void* const* b2s, void* const* outs, int group,
                         void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nb < 1 || nb > MAX_BRANCHES || group < 1 || (nt != 40 && nt != 80) ||
      cnc < 1 || cnc > 16) {
    return bad;
  }
  TcParams p;
  p.seg = static_cast<const __nv_bfloat16*>(seg);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.N = N;
  p.H = H;
  p.W = W;
  p.cnc = cnc;
  p.nb = nb;
  p.group = group;
  p.groups = 0;
  int off = 0, hid_max = 0;
  for (int b = 0; b < nb; ++b) {
    if (hid_pads[b] != hid_pads[0] || hid_pads[b] % 32 != 0 || hid_pads[b] < 32 ||
        hid_pads[b] > 128 || chunks[b] * nt < couts[b] ||
        couts[b] % 2 != 0) {
      return bad;
    }
    p.br[b].hid_off = off;
    p.br[b].cout = couts[b];
    p.br[b].chunks = chunks[b];
    p.br[b].w2 = static_cast<const __nv_bfloat16*>(w2s[b]);
    p.br[b].b2 = static_cast<const float*>(b2s[b]);
    p.br[b].out = static_cast<__nv_bfloat16*>(outs[b]);
    off += hid_pads[b];
    hid_max = hid_pads[b] > hid_max ? hid_pads[b] : hid_max;
    p.groups += (chunks[b] + group - 1) / group;
  }
  if (static_cast<long long>(N) * p.groups > 65535 || (H + TH - 1) / TH > 65535) {
    return bad;
  }
  const int cpt = cnc <= 8 ? 8 : 16;
  const TcLayout l = tc_layout(hid_max, nt, cpt);
  p.act_off = l.act_off;
  p.win_off = l.win_off;
  p.w1_off = l.w1_off;
  p.bar_off = l.bar_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hs = hid_max / 32;  // one hid_pad of at most 128 for all branches
  if (cpt == 8) {
    return nt == 40 ? launch_tc_hs<40, 8>(p, hs, l.total, s)
                    : launch_tc_hs<80, 8>(p, hs, l.total, s);
  }
  return nt == 40 ? launch_tc_hs<40, 16>(p, hs, l.total, s)
                  : launch_tc_hs<80, 16>(p, hs, l.total, s);
}

const char* spade_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
