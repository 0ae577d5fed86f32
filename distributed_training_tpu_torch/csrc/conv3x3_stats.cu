// Stride-1 SAME 3x3 convolution with the per-channel sum and sum of squares
// of its float32 result, for Hopper (sm_90a), in float32 or bfloat16.
//
// Replaces the Pallas kernel of tools/conv_fusion_probe.py,
// pallas_conv3x3_stats (body _conv_kernel, conv_fusion_probe.py:55): x
// [N, H, W, Cin] (NHWC), w [3, 3, Cin, Cout] (HWIO) -> out [N, H, W, Cout]
// in x's dtype, and the sums over N, H, W of the float32 accumulator and of
// its square, taken before the cast. The TPU kernel wrote one partial per
// program and summed them outside; so does this one, one partial per block
// ([blocks, Cout], no atomics, so the sums repeat bit for bit), summed by
// the caller. Each partial starts at zero (the TPU kernel's first partial
// read its uninitialised output times 0, NaN in interpret mode).
//
// What bounds it on an H100 80GB HBM3 at its 700 W limit: at the ResNet-50
// shapes of the probe (batch 256; s0 56x56 64->64, s1 28x28 128->128, s2
// 14x14 256->256, bf16) each conv is 59.19 GFLOP, 0.0598 ms at the 989
// TFLOP/s bf16 tensor-core rate; x and out read and written once are 205.5
// MB at s0 (0.0613 ms at 3.35 TB/s, bound by bytes), 102.8 MB at s1 and
// 51.4 MB at s2 (bound by operations, 0.0598 ms). This first version runs
// every product as a float32 FMA on CUDA cores, whose 67 TFLOP/s float32
// rate puts its own ceiling at 0.88 ms or more; tensor cores are later
// work. Design, simple and right first:
//   - an implicit GEMM over the 9 taps x Cin: a block of 256 threads owns
//     an 8 x 8 tile of output pixels of one image and a 64-wide slice of
//     Cout; each thread a 4 x 4 register tile (pixels ty + 16 i, channels
//     4 tx .. 4 tx + 3);
//   - Cin is staged 16 channels at a time: the 10 x 10 input tile with its
//     one-pixel halo and the 9 x 16 x 64 weights, as float32 in shared
//     memory; zero padding is a predicate on the load (no padded copy of
//     x, unlike the TPU's jnp.pad), and so are ragged tiles and channels;
//   - the epilogue writes out in x's dtype and reduces the block's
//     float32 accumulators into its partial sums through shared memory,
//     in a fixed order.
//
// C interface (bound with ctypes): one launch on the given stream,
// returning cudaGetLastError().

#include "elem.cuh"

namespace {

constexpr int kTile = 8;                  // output pixels a side
constexpr int kHaloW = kTile + 2;         // input pixels a side
constexpr int kCo = 64;                   // output channels a block
constexpr int kCc = 16;                   // input channels a stage
constexpr int kLdx = kCc + 4;             // floats per staged input pixel
constexpr int kThreads = 256;             // 16 x 16
constexpr int kXFloats = kHaloW * kHaloW * kLdx;
constexpr int kWFloats = 9 * kCc * kCo;

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, float* __restrict__ psum,
                     float* __restrict__ psumsq, int h, int wd, int cin,
                     int cout, int tiles_x, int tiles) {
  __shared__ float4 smem4[(kXFloats + kWFloats) / 4];
  float* xs = reinterpret_cast<float*>(smem4);  // [kHaloW^2][kLdx]
  float* ws = xs + kXFloats;                    // [9][kCc][kCo]

  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;
  const int co0 = blockIdx.y * kCo;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* xn = x + (size_t)n * h * wd * cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCc) {
    __syncthreads();  // the last stage's xs and ws are read
    for (int i = threadIdx.x; i < kHaloW * kHaloW * (kCc / 4); i += kThreads) {
      const int hp = i / (kCc / 4);
      const int c = (i % (kCc / 4)) * 4;
      const int gy = y0 - 1 + hp / kHaloW;
      const int gx = x0 - 1 + hp % kHaloW;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + c < cin)
        val = Elem<T>::load4(xn + ((size_t)gy * wd + gx) * cin + c0 + c);
      *reinterpret_cast<float4*>(xs + hp * kLdx + c) = val;
    }
    for (int i = threadIdx.x; i < 9 * kCc * (kCo / 4); i += kThreads) {
      const int co = (i % (kCo / 4)) * 4;
      const int ci = (i / (kCo / 4)) % kCc;
      const int tap = i / ((kCo / 4) * kCc);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + ci < cin && co0 + co < cout)
        val = Elem<T>::load4(w + ((size_t)tap * cin + c0 + ci) * cout + co0 + co);
      *reinterpret_cast<float4*>(ws + (tap * kCc + ci) * kCo + co) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ci = 0; ci < kCc; ci += 4) {
        float4 xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = ty + 16 * i;
          const int hp = (p / kTile + dy) * kHaloW + p % kTile + dx;
          xv[i] = lds4(xs + hp * kLdx + ci);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 wv = lds4(ws + (tap * kCc + ci + cc) * kCo + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = comp(xv[i], cc);
            acc[i][0] = fmaf(a, wv.x, acc[i][0]);
            acc[i][1] = fmaf(a, wv.y, acc[i][1]);
            acc[i][2] = fmaf(a, wv.z, acc[i][2]);
            acc[i][3] = fmaf(a, wv.w, acc[i][3]);
          }
        }
      }
    }
  }

  // out, and this thread's share of the block's sums.
  const int co = co0 + 4 * tx;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    const int gy = y0 + p / kTile, gx = x0 + p % kTile;
    if (gy >= h || gx >= wd) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += acc[i][j];
      ss[j] = fmaf(acc[i][j], acc[i][j], ss[j]);
    }
    if (co < cout)
      Elem<T>::store4(out + (((size_t)n * h + gy) * wd + gx) * cout + co,
                      make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }

  // Reduce over the 16 rows of threads (ty) in a fixed order.
  __syncthreads();  // xs and ws are read; reuse them
  float* red_s = xs;               // [16][kCo]
  float* red_ss = xs + 16 * kCo;   // [16][kCo]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty * kCo + 4 * tx + j] = s[j];
    red_ss[ty * kCo + 4 * tx + j] = ss[j];
  }
  __syncthreads();
  if (threadIdx.x < kCo && co0 + threadIdx.x < cout) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < 16; ++r) {
      a += red_s[r * kCo + threadIdx.x];
      b += red_ss[r * kCo + threadIdx.x];
    }
    const size_t off = (size_t)blockIdx.x * cout + co0 + threadIdx.x;
    psum[off] = a;
    psumsq[off] = b;
  }
}

}  // namespace

extern "C" {

// Blocks along the pixels (N times the 8 x 8 tiles of an image): the rows
// of the partial sums the caller allocates.
long long conv3x3_stats_blocks(int n, int h, int wd) {
  return (long long)n * ((h + kTile - 1) / kTile) * ((wd + kTile - 1) / kTile);
}

// x: [n, h, wd, cin], w: [3, 3, cin, cout], out: [n, h, wd, cout], all
// contiguous, of one dtype, float32 (is_bf16 = 0) or bfloat16 (is_bf16 =
// 1), 16-byte aligned; cin and cout multiples of 4. psum, psumsq: float32
// [conv3x3_stats_blocks(n, h, wd), cout].
int conv3x3_stats(const void* x, const void* w, void* out, void* psum,
                  void* psumsq, int n, int h, int wd, int cin, int cout,
                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = conv3x3_stats_blocks(n, h, wd);
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % 4 ||
      cout % 4 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (wd + kTile - 1) / kTile;
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  const dim3 grid((unsigned)blocks, (unsigned)((cout + kCo - 1) / kCo));
  float* ps = static_cast<float*>(psum);
  float* pss = static_cast<float*>(psumsq);
  if (is_bf16)
    conv3x3_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), ps, pss, h, wd, cin, cout, tiles_x,
        tiles);
  else
    conv3x3_stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), ps, pss, h, wd, cin, cout, tiles_x, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
