// Stride-1 SAME 3x3 convolution with the per-channel sum and sum of squares
// of its float32 result, for Hopper (sm_90a), in float32, bfloat16 or
// float16.
//
// Replaces the Pallas kernel of tools/conv_fusion_probe.py,
// pallas_conv3x3_stats (body _conv_kernel, conv_fusion_probe.py:55): x
// [N, H, W, Cin] (NHWC), w [3, 3, Cin, Cout] (HWIO) -> out [N, H, W, Cout]
// in x's dtype, and the sums over N, H, W of the float32 accumulator and of
// its square, taken before the cast. The TPU kernel wrote one partial per
// program and summed them outside; so does this one, one partial per block
// of pixels ([blocks, Cout], no atomics, so the sums repeat bit for bit),
// summed by the caller. Each partial starts at zero (the TPU kernel's
// first partial read its uninitialised output times 0, NaN in interpret
// mode).
//
// What bounds it on an H100 80GB HBM3 at its 700 W limit: at the ResNet-50
// shapes of the probe (batch 256; s0 56x56 64->64, s1 28x28 128->128, s2
// 14x14 256->256, bf16) each conv is 59.19 GFLOP, 0.0598 ms at the 989
// TFLOP/s bf16 tensor-core rate; x and out read and written once are 205.5
// MB at s0 (0.0613 ms at 3.35 TB/s, bound by bytes), 102.8 MB at s1 and
// 51.4 MB at s2 (bound by operations, 0.0598 ms).
//
// bfloat16 and float16 (conv_wgmma::conv_kernel<T, NC>, one instantiation
// per type) run on the tensor cores, an implicit
// GEMM of M = 64 output pixels (an 8 x 8 tile of one image) by N = 64
// output channels (32 where Cout <= 32) by K = 9 taps x Cin, one
// warpgroup a block:
//   - the K loop runs over chunks of 64 input channels and, inside a
//     chunk, over the 9 taps; each (chunk, tap) step is a 64 x N x 64
//     product, four wgmma k steps;
//   - A (pixels x channels) is a shifted window of the chunk's 10 x 10
//     halo tile in shared memory. A descriptor cannot express the shift
//     (its 8-row core matrices would start off the swizzle atom), so each
//     lane gives ldmatrix.x4 its own row address, halo pixel (py + dy) 10
//     + px + dx, and the four 8 x 8 matrices are wgmma's register A
//     fragment. The halo's 16-byte chunks sit at their index XOR the halo
//     pixel's index mod 8, so the 8 rows of an ldmatrix phase (8
//     consecutive halo pixels) hit distinct banks;
//   - B (channels x Cout) = w[tap, c0:c0+64, co0:co0+N], Cout contiguous:
//     MN-major under the 128-byte swizzle (64-byte at N 32), the layout
//     of V in the flash forward;
//   - both are staged by cp.async, double-buffered: the next step's
//     weights and, at a chunk's last tap, the next chunk's halo are in
//     flight while the current product runs. Zero padding, ragged tiles
//     and channels past Cin or Cout are cp.async's zero fill (a source
//     size of 0): no padded copy of x, unlike the TPU's jnp.pad;
//   - each step's product starts from zero in the wgmma accumulator and
//     is added into the block's float32 sum with round-to-nearest adds,
//     as the TPU kernel adds each tap's dot into its float32 scratch: the
//     tensor cores' own accumulation rounds toward zero, and over the 9 x
//     Cin / 16 steps of one long chain that bias would show in the sum of
//     squares;
//   - the epilogue writes out in T from the accumulator fragment and
//     reduces each channel's sum and sum of squares over the tile's valid
//     pixels only (rows past the image edge are built from zero-filled
//     halo pixels but still pick up real neighbours, so they are not
//     zero), by shuffles over the 8 lanes of a column, then across the 4
//     warps through shared memory, in a fixed order.
// It needs 16-byte rows: Cin and Cout multiples of 8 (the wrapper pads
// other channel counts with zero channels and slices the result).
//
// float32 (conv3x3_stats_kernel) keeps its CUDA-core kernel: on the tensor
// cores it would run as TF32, which cannot hold the float32 limits. Every
// product is a float32 FMA (ceiling: 67 TFLOP/s, 0.88 ms or more at the
// probe's shapes): a block of 256 threads owns an 8 x 8 pixel tile and a
// 64-wide slice of Cout, each thread a 4 x 4 register tile; Cin is staged
// 16 channels at a time with the 9 x 16 x 64 weights, as float32 in
// shared memory; Cin and Cout multiples of 4.
//
// C interface (bound with ctypes): one launch on the given stream,
// returning cudaGetLastError().

#include "elem.cuh"
#include "wgmma.cuh"

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

__global__ void __launch_bounds__(kThreads)
conv3x3_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, float* __restrict__ psum,
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
  const float* xn = x + (size_t)n * h * wd * cin;

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
        val = Elem<float>::load4(xn + ((size_t)gy * wd + gx) * cin + c0 + c);
      *reinterpret_cast<float4*>(xs + hp * kLdx + c) = val;
    }
    for (int i = threadIdx.x; i < 9 * kCc * (kCo / 4); i += kThreads) {
      const int co = (i % (kCo / 4)) * 4;
      const int ci = (i / (kCo / 4)) % kCc;
      const int tap = i / ((kCo / 4) * kCc);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + ci < cin && co0 + co < cout)
        val = Elem<float>::load4(w + ((size_t)tap * cin + c0 + ci) * cout + co0 + co);
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
      Elem<float>::store4(out + (((size_t)n * h + gy) * wd + gx) * cout + co,
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

namespace conv_wgmma {

using namespace sm90;  // the PTX wrappers and Tile (wgmma.cuh)
using sm90::bf16;
using sm90::kThreads;  // one warpgroup

constexpr int kChunk = 64;                          // input channels a chunk
constexpr int kHaloPixels = kHaloW * kHaloW;        // 100
constexpr int kHaloBytes = kHaloPixels * kChunk * 2;  // 128 bytes a pixel

// Byte offset of the 16-byte chunk c of halo pixel hp: the chunks of a
// pixel sit at their index XOR the pixel's index mod 8.
__device__ __forceinline__ uint32_t halo_offset(int hp, int c) {
  return hp * (kChunk * 2) + ((c ^ (hp & 7)) << 4);
}

// Channels [c0, c0 + 64) of the 10 x 10 input pixels around the output
// tile at (y0, x0), asynchronously; pixels off the image and channels past
// cin read as zeros.
template <typename T>
__device__ __forceinline__ void load_halo(uint32_t hs, const T* xn, int y0,
                                          int x0, int c0, int h, int wd,
                                          int cin, int tid) {
  for (int i = tid; i < kHaloPixels * 8; i += kThreads) {
    const int hp = i >> 3, c = i & 7;
    const int gy = y0 - 1 + hp / kHaloW, gx = x0 - 1 + hp % kHaloW;
    const int ch = c0 + 8 * c;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < cin;
    cp_async16(hs + halo_offset(hp, c),
               in ? xn + ((size_t)gy * wd + gx) * cin + ch : xn, in ? 16 : 0);
  }
}

// w[tap, c0:c0+64, co0:co0+NC] into a [64, NC] tile, asynchronously; rows
// past cin and columns past cout read as zeros.
template <typename T, int NC>
__device__ __forceinline__ void load_weights(uint32_t ws, const T* w,
                                             int tap, int c0, int co0,
                                             int cin, int cout, int tid) {
  constexpr int kChunksPerRow = NC / 8;
#pragma unroll
  for (int i = tid; i < kChunk * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 8;
    const bool in = c0 + r < cin && co0 + c < cout;
    cp_async16(ws + Tile<NC>::offset(r, c),
               in ? w + ((size_t)tap * cin + c0 + r) * cout + co0 + c : w,
               in ? 16 : 0);
  }
}

// Shared memory: two stages of weights, then two of the halo; 1024 bytes
// of alignment.
template <int NC>
constexpr size_t smem_bytes() {
  return 2 * (size_t)Tile<NC>::kBytes + 2 * (size_t)kHaloBytes + 1024;
}

// One block: the 8 x 8 output pixels of pixel block blockIdx.x / co_blocks
// by the NC output channels of slice blockIdx.x % co_blocks (see the note
// at the top of the file).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, float* __restrict__ psum,
            float* __restrict__ psumsq, int h, int wd, int cin, int cout,
            int tiles_x, int tiles, int co_blocks) {
  using TW = Tile<NC>;
  extern __shared__ uint8_t smem[];
  __shared__ float red[2][4][NC];  // each warp's sums, sums of squares
  const uint32_t ws0 = (smem_u32(smem) + 1023) & ~1023u;
  auto ws = [&](int st) { return ws0 + st * TW::kBytes; };
  auto hs = [&](int st) { return ws0 + 2 * TW::kBytes + st * kHaloBytes; };

  const int pix_block = blockIdx.x / co_blocks;
  const int co0 = (blockIdx.x % co_blocks) * NC;
  const int n = pix_block / tiles;
  const int tile = pix_block % tiles;
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;
  const T* xn = x + (size_t)n * h * wd * cin;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  // The output pixel whose row of A this lane addresses for ldmatrix, and
  // its halo pixel at tap (0, 0).
  const int p = 16 * warp + (lane & 15);
  const int hp0 = (p / kTile) * kHaloW + p % kTile;
  const int nsteps = 9 * ((cin + kChunk - 1) / kChunk);

  load_halo<T>(hs(0), xn, y0, x0, 0, h, wd, cin, tid);
  load_weights<T, NC>(ws(0), w, 0, 0, co0, cin, cout, tid);
  cp_async_commit();

  float acc[NC / 2], part[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = part[i] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int tap = s % 9, chunk = s / 9;
    __syncthreads();  // step s - 1's product is done: its stages are free
    if (s + 1 < nsteps) {
      const int next_tap = (s + 1) % 9, next_c0 = (s + 1) / 9 * kChunk;
      if (next_tap == 0)
        load_halo<T>(hs((chunk + 1) & 1), xn, y0, x0, next_c0, h, wd, cin, tid);
      load_weights<T, NC>(ws((s + 1) & 1), w, next_tap, next_c0, co0, cin, cout,
                       tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // step s's halo and weights landed
    fence_proxy_async();
    __syncthreads();

    const int hp = hp0 + (tap / 3) * kHaloW + tap % 3;
    const uint32_t row = hs(chunk & 1);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a[kk], row + halo_offset(hp, 2 * kk + (lane >> 4)));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, NC, 1>(part, a[kk], TW::mn_major(ws(s & 1), 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(a);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] += part[i];
  }

  // out, and each column's sum and sum of squares over this thread's valid
  // rows: accumulator register i is row r0 + 8 ((i >> 1) & 1), column
  // 8 (i / 4) + cq + (i & 1); row r is pixel (y0 + r / 8, x0 + r % 8).
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  bool valid[2];
  size_t at[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    const int gy = y0 + r / kTile, gx = x0 + r % kTile;
    valid[hh] = gy < h && gx < wd;
    at[hh] = (((size_t)n * h + gy) * wd + gx) * cout;
  }
  float cs[NC / 4], css[NC / 4];  // columns 8 j + cq + e at 2 j + e
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = co0 + 8 * j + cq;
      if (valid[hh] && co < cout)
        *reinterpret_cast<uint32_t*>(out + at[hh] + co) =
            pack2<T>(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = valid[0] ? acc[4 * j + e] : 0.f;
      const float v1 = valid[1] ? acc[4 * j + 2 + e] : 0.f;
      cs[2 * j + e] = v0 + v1;
      css[2 * j + e] = fmaf(v1, v1, v0 * v0);
    }
  }
  // Over the 8 lanes of a column (lane / 4), then across the warps.
#pragma unroll
  for (int i = 0; i < NC / 4; ++i)
#pragma unroll
    for (int m = 4; m < 32; m *= 2) {
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], m);
      css[i] += __shfl_xor_sync(0xffffffffu, css[i], m);
    }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < NC / 4; ++i) {
      const int c = 8 * (i / 2) + cq + (i & 1);
      red[0][warp][c] = cs[i];
      red[1][warp][c] = css[i];
    }
  }
  __syncthreads();
  if (tid < NC && co0 + tid < cout) {
    const size_t off = (size_t)pix_block * cout + co0 + tid;
    psum[off] = ((red[0][0][tid] + red[0][1][tid]) + red[0][2][tid]) + red[0][3][tid];
    psumsq[off] = ((red[1][0][tid] + red[1][1][tid]) + red[1][2][tid]) + red[1][3][tid];
  }
}

template <typename T, int NC>
int launch(const void* x, const void* w, void* out, float* psum,
           float* psumsq, int h, int wd, int cin, int cout, int tiles_x,
           int tiles, long long pixel_blocks, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NC>();
  const int co_blocks = (cout + NC - 1) / NC;
  if (pixel_blocks * co_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_kernel<T, NC><<<(unsigned)(pixel_blocks * co_blocks), kThreads, smem,
                    stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), psum, psumsq, h, wd, cin, cout, tiles_x, tiles,
      co_blocks);
  return (int)cudaGetLastError();
}

}  // namespace conv_wgmma

extern "C" {

// Blocks along the pixels (N times the 8 x 8 tiles of an image): the rows
// of the partial sums the caller allocates.
long long conv3x3_stats_blocks(int n, int h, int wd) {
  return (long long)n * ((h + kTile - 1) / kTile) * ((wd + kTile - 1) / kTile);
}

// x: [n, h, wd, cin], w: [3, 3, cin, cout], out: [n, h, wd, cout], all
// contiguous, of one dtype, float32 (dtype = 0; cin and cout multiples of
// 4), bfloat16 (dtype = 1) or float16 (dtype = 2; multiples of 8), 16-byte
// aligned. psum,
// psumsq: float32 [conv3x3_stats_blocks(n, h, wd), cout].
int conv3x3_stats(const void* x, const void* w, void* out, void* psum,
                  void* psumsq, int n, int h, int wd, int cin, int cout,
                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = conv3x3_stats_blocks(n, h, wd);
  const int align = dtype == 0 ? 4 : 8;
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % align ||
      cout % align || dtype < 0 || dtype > 2 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (wd + kTile - 1) / kTile;
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  float* ps = static_cast<float*>(psum);
  float* pss = static_cast<float*>(psumsq);
#define CONV_WGMMA(T)                                                    \
  return cout <= 32 ? conv_wgmma::launch<T, 32>(x, w, out, ps, pss, h, wd, \
                                                cin, cout, tiles_x, tiles, \
                                                blocks, s)                 \
                    : conv_wgmma::launch<T, 64>(x, w, out, ps, pss, h, wd, \
                                                cin, cout, tiles_x, tiles, \
                                                blocks, s)
  if (dtype == 1) CONV_WGMMA(__nv_bfloat16);
  if (dtype == 2) CONV_WGMMA(__half);
#undef CONV_WGMMA
  const dim3 grid((unsigned)blocks, (unsigned)((cout + kCo - 1) / kCo));
  conv3x3_stats_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), ps, pss, h, wd, cin, cout, tiles_x, tiles);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the tensor-core kernel (bf16 and fp16
// alike) takes at nc output channels a block (32 or 64); -1 for anything
// else.
int conv3x3_stats_wgmma_smem_bytes(int nc) {
  return nc == 32   ? (int)conv_wgmma::smem_bytes<32>()
         : nc == 64 ? (int)conv_wgmma::smem_bytes<64>()
                    : -1;
}

}  // extern "C"
