// bf16 and fp16 flash-attention tiles on Hopper's tensor cores (sm_90a):
// the forward (K2), the backward's k-tile loop (K3 with dQ, K4b without) and
// the split backward's q-tile loop (K4a, dQ only), included by
// flash_attention.cu and flash_attention_split.cu; the PTX wrappers and the
// swizzled tile are wgmma.cuh's. Every kernel is a template on the element
// type T (bf16 or fp16): the two differ only in the wgmma instruction's
// operand type and in the rounding of p, p^T and dS^T into A fragments
// (pack2<T>), as the JAX kernels round p to the value dtype in either. float32 inputs keep the CUDA-core loops of flash_tiles.cuh
// and flash_attention_split.cu: on the tensor cores they would run as
// TF32, which cannot hold the float32 limit.
//
// Design, one warpgroup (128 threads) per block, one 64-row tile a block:
//   - Tiles stay T in shared memory in the layout wgmma reads: rows of
//     a [64, D] tile in column blocks of 64 values (128 bytes, the row of
//     the 128-byte swizzle; D 128 is two such blocks, D 256 four), or at D 32 rows of
//     64 bytes under the 64-byte swizzle. Each 16-byte chunk of a row sits
//     at its index XOR the row's (Tile::offset), so the wgmma reads and the
//     per-thread stores below hit distinct banks.
//   - Every tile product is wgmma.mma_async with float32 accumulators in
//     registers. Forward: S = Q K^T (A = Q, B = K, both K-major), then
//     O += P V with A = P from registers (the S accumulator rounded to
//     T in place: its fragment is the A fragment of the next product)
//     and B = V MN-major (the transpose bit). Backward, per live q tile:
//     S^T = K Q^T and dP^T = V dO^T; dV += P^T dO and dK += dS^T Q with A
//     from registers; dQ = dS K with A = dS^T written once to shared
//     memory and read transposed, B = K transposed. K4a, per live k tile:
//     S = Q K^T and dP = dO V^T, then dQ += dS K with A = dS from
//     registers and B = K MN-major.
//   - Loads are cp.async, 16 bytes a thread into the swizzled addresses,
//     double-buffered: the next K/V tile (forward, K4a) or Q/dO tile with
//     its lse and delta (backward) is in flight while the current one's
//     products run. cp.async and not TMA: its zero fill (a source size of
//     0) reads rows past T as zeros for any T and any BH without a tensor
//     map per call, and a block's 128 threads issue a tile in 2-8 copies
//     each. A cp.async write is a generic-proxy write, so each thread
//     fences to the async proxy before the barrier that precedes wgmma.
//   - Only the diagonal tile (causal) and a ragged tile (T not a multiple
//     of 64) compute the mask.
//   - K3's dQ goes into the caller's zeroed float32 buffer by vector reductions
//     (atomicAdd on float4, red.global.add.v4.f32 on sm_90), after one
//     shuffle that gives each lane four consecutive values of a row: a
//     quarter of the atomics of the scalar form.
//   - A block owns at most 128 columns of its outputs (two column blocks),
//     so its float32 accumulators (O; dK and dV; dQ) take at most 64
//     registers a thread each. At D 256 (Gemma's head width) a tile's
//     outputs are split between kParts = 2 blocks, each of which computes
//     the whole score tile S (and dP) over all 256 columns of Q and K and
//     then its own half of O, dK and dV or dQ: 1.5x the forward's
//     products and 1.4x K3's, against dK and dV at 64 x 256 each, which
//     would take 256 accumulator registers a thread in one warpgroup, past
//     the 255 a thread may have.
// Numerics as flash_tiles.cuh: scores and products accumulate in float32,
// masked scores are -1e30, p is rounded to T before it multiplies V or
// dO and dS before it multiplies Q or K, a row with l = 0 writes 0 and
// lse = m + log(max(l, 1e-30)); use_exp2 branches once per tile.

#pragma once

#include "flash_tiles.cuh"
#include "wgmma.cuh"

namespace flash_wgmma {

using namespace sm90;  // the PTX wrappers and Tile (wgmma.cuh)
using sm90::bf16;
using sm90::kRows;     // rows of every tile: queries or keys
using sm90::kThreads;  // one warpgroup
using flash::kLog2e;
using flash::kNegInf;
using flash::softmax_exp;

// Output column blocks a block owns (kOwn), and the blocks a 64-row tile's
// outputs are split between (kParts): one block owns all of them up to D
// 128, two blocks own half each at D 256.
template <int D>
struct Cols {
  static constexpr int kOwn = Tile<D>::kBlocks < 2 ? Tile<D>::kBlocks : 2;
  static constexpr int kParts = Tile<D>::kBlocks / kOwn;
};

// Columns of d a product step of the d > 256 kernels takes, and output
// columns each of their blocks owns (the end of this file).
constexpr int kSlab = 64;

// --------------------------------------------------------- loads

// Rows [row0, row0 + 64) of a [t, D] matrix into a tile, asynchronously;
// rows at or past t read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* g,
                                          int row0, int t, int tid) {
  constexpr int kChunksPerRow = D / 8;
#pragma unroll
  for (int i = tid; i < kRows * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 8;
    const bool in = row0 + r < t;
    cp_async16(tile + Tile<D>::offset(r, c),
               g + (size_t)(in ? row0 + r : 0) * D + c, in ? 16 : 0);
  }
}

// lse and delta of the query rows [q0, q0 + 64), asynchronously; rows at or
// past t read as zeros.
__device__ __forceinline__ void load_row_stats(uint32_t lse_s, uint32_t delta_s,
                                               const float* lse,
                                               const float* delta,
                                               size_t row_base, int q0, int t,
                                               int tid) {
  const int i = tid % kRows;
  const bool in = q0 + i < t;
  const size_t at = row_base + (in ? q0 + i : 0);
  if (tid < kRows)
    cp_async4(lse_s + 4 * i, lse + at, in ? 4 : 0);
  else
    cp_async4(delta_s + 4 * i, delta + at, in ? 4 : 0);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragments (64 x N float32, N / 2 a thread): register i of a
// thread holds row r0 + 8 ((i >> 1) & 1) and column 8 (i / 4) + cq + (i &
// 1), r0 = 16 warp + lane / 4, cq = 2 (lane % 4). The T A fragment of
// k step kk of a product over those columns is registers 8 kk .. 8 kk + 7
// taken in pairs, so an accumulator becomes an A operand in place.
template <typename T>
__device__ __forceinline__ void to_a_fragments(const float (&s)[32],
                                               uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// ------------------------------------------------------------------ forward

// One k tile's step of the online softmax on the S accumulator: scale and
// (edge tiles only) mask, running max m and this thread's part of the sum
// l for its two rows, O rescaled, P rounded into A fragments.
template <typename T, bool kExp2, int D>
__device__ __forceinline__ void fwd_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2],
    float (&o)[Cols<D>::kOwn][Tile<D>::kCols / 2], uint32_t (&p)[4][4],
    bool edge, int row0, int col0, int t, int causal, float sscale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = s[i] * sscale;
    if (edge) {
      const int col = col0 + 8 * (i / 4) + (i & 1);
      if (col >= t || (causal && col > row0 + 8 * h)) x = kNegInf;
    }
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    corr[h] = softmax_exp<kExp2>(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = softmax_exp<kExp2>(s[i] - m[h]);
    rs[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
  for (int b = 0; b < Cols<D>::kOwn; ++b)
#pragma unroll
    for (int i = 0; i < Tile<D>::kCols / 2; ++i) o[b][i] *= corr[(i >> 1) & 1];
  to_a_fragments<T>(s, p);
}

// Shared memory: Q, then two stages of (K, V); 1024 bytes of alignment.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return 5 * (size_t)Tile<D>::kBytes + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, int bh_count, int t, int causal,
           int use_exp2, float scale) {
  using TL = Tile<D>;
  using CO = Cols<D>;
  extern __shared__ uint8_t smem[];
  const uint32_t qs = (smem_u32(smem) + 1023) & ~1023u;
  auto ks = [&](int st) { return qs + (1 + 2 * st) * TL::kBytes; };
  auto vs = [&](int st) { return qs + (2 + 2 * st) * TL::kBytes; };

  const int nq = (t + kRows - 1) / kRows;
  const int bh = blockIdx.x % bh_count;
  const int part = (blockIdx.x / bh_count) % CO::kParts;
  const int b0 = part * CO::kOwn;  // the first column block this block owns
  const int q0 = (nq - 1 - blockIdx.x / (bh_count * CO::kParts)) * kRows;  // heaviest first
  const size_t base = (size_t)bh * t * D;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int cq = 2 * (tid % 4);
  const float sscale = use_exp2 ? scale * kLog2e : scale;
  const int k_end = causal ? min(t, q0 + kRows) : t;
  const int nk = (k_end + kRows - 1) / kRows;

  load_tile<T, D>(qs, q + base, q0, t, tid);
  load_tile<T, D>(ks(0), k + base, 0, t, tid);
  load_tile<T, D>(vs(0), v + base, 0, t, tid);
  cp_async_commit();

  float o[CO::kOwn][TL::kCols / 2];
#pragma unroll
  for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
    for (int i = 0; i < TL::kCols / 2; ++i) o[b][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kRows;
    __syncthreads();  // tile j - 1's products are done: its stage is free
    if (j + 1 < nk) {
      load_tile<T, D>(ks((j + 1) & 1), k + base, k0 + kRows, t, tid);
      load_tile<T, D>(vs((j + 1) & 1), v + base, k0 + kRows, t, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) landed
    fence_proxy_async();
    __syncthreads();

    float s[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T, 0, 0>(s, TL::k_major(qs, kk), TL::k_major(ks(j & 1), kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool edge = (causal && k0 == q0) || k0 + kRows > t;
    uint32_t p[4][4];
    if (use_exp2)
      fwd_softmax<T, true, D>(s, m, l, o, p, edge, q0 + r0, k0 + cq, t, causal,
                           sscale);
    else
      fwd_softmax<T, false, D>(s, m, l, o, p, edge, q0 + r0, k0 + cq, t, causal,
                            sscale);

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, TL::kCols, 1>(o[b], p[kk],
                                  TL::mn_major(vs(j & 1), b0 + b, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const int row = q0 + r0 + 8 * h;
    if (row >= t) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
      for (int i = 2 * h; i < TL::kCols / 2; i += 4) {
        const int col = (b0 + b) * TL::kCols + 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(out + base + (size_t)row * D + col) =
            pack2<T>(o[b][i] * inv, o[b][i + 1] * inv);
      }
    if (cq == 0 && part == 0) {
      const float lm = fmaxf(l[h], 1e-30f);
      lse[(size_t)bh * t + row] =
          use_exp2 ? (m[h] + log2f(lm)) / kLog2e : m[h] + logf(lm);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int t, int causal, int use_exp2,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  unsigned blocks;
  if (int e = flash::blocks_for(t, kRows, bh * Cols<D>::kParts, &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<T, D><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, bh, t, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- backward

// p^T (rounded) and dS^T (rounded) of one (k tile, q tile) pair as A
// fragments, from the S^T and dP^T accumulators (keys by rows, queries by
// columns). Edge tiles zero p outside the mask, rows past t included.
template <typename T, bool kExp2>
__device__ __forceinline__ void bwd_probs(float (&st)[32], float (&dpt)[32],
                                          const float* lse_s,
                                          const float* delta_s,
                                          uint32_t (&pt)[4][4],
                                          uint32_t (&dst)[4][4], bool edge,
                                          int key0, int q0, int cq, int t,
                                          int causal, float sscale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ql = 8 * (i / 4) + cq + (i & 1);
    const float l = kExp2 ? lse_s[ql] * kLog2e : lse_s[ql];
    float p = softmax_exp<kExp2>(st[i] * sscale - l);
    if (edge) {
      const int key = key0 + 8 * ((i >> 1) & 1);
      const int row = q0 + ql;
      if (row >= t || key >= t || (causal && key > row)) p = 0.f;
    }
    dpt[i] = p * (dpt[i] - delta_s[ql]);
    st[i] = p;
  }
  to_a_fragments<T>(st, pt);
  to_a_fragments<T>(dpt, dst);
}

// Shared memory: K, V, two stages of (Q, dO), with kDq the dS^T tile, then
// two stages of (lse, delta); 1024 bytes of alignment.
template <int D, bool kDq>
constexpr size_t bwd_smem_bytes() {
  return 6 * (size_t)Tile<D>::kBytes + (kDq ? Tile<64>::kBytes : 0) +
         4 * kRows * sizeof(float) + 1024;
}

// dK and dV of one 64-key tile (the block's columns of them) over the live
// q tiles, in registers, written once. With kDq (K3) each q tile's dQ = dS
// K (the block's columns) is added into dq_acc by vector reductions;
// without it (K4b) dq_acc is not touched.
template <typename T, int D, bool kDq>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq_acc, T* __restrict__ dk,
           T* __restrict__ dv, int bh_count, int t, int causal,
           int use_exp2, float scale) {
  using TL = Tile<D>;
  using CO = Cols<D>;
  extern __shared__ uint8_t smem[];
  const uint32_t ks = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t vs = ks + TL::kBytes;
  auto qs = [&](int st) { return ks + (2 + 2 * st) * TL::kBytes; };
  auto dos = [&](int st) { return ks + (3 + 2 * st) * TL::kBytes; };
  const uint32_t dss = ks + 6 * TL::kBytes;  // dS^T [key][query], kDq only
  const uint32_t stats = dss + (kDq ? Tile<64>::kBytes : 0);
  // lse of stage st at stats + 512 st, delta 256 bytes after it.
  const float* stats_f =
      reinterpret_cast<const float*>(smem + (stats - smem_u32(smem)));

  const int bh = blockIdx.x % bh_count;
  const int b0 = (blockIdx.x / bh_count) % CO::kParts * CO::kOwn;
  const int k0 = (blockIdx.x / (bh_count * CO::kParts)) * kRows;  // heaviest (k0 = 0) first
  const size_t base = (size_t)bh * t * D;
  const size_t row_base = (size_t)bh * t;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int cq = 2 * (tid % 4);
  const float sscale = use_exp2 ? scale * kLog2e : scale;
  const int q_start = causal ? k0 : 0;
  const int n_q = (t - q_start + kRows - 1) / kRows;

  load_tile<T, D>(ks, k + base, k0, t, tid);
  load_tile<T, D>(vs, v + base, k0, t, tid);
  load_tile<T, D>(qs(0), q + base, q_start, t, tid);
  load_tile<T, D>(dos(0), dout + base, q_start, t, tid);
  load_row_stats(stats, stats + 256, lse, delta, row_base, q_start, t, tid);
  cp_async_commit();

  float dk_acc[CO::kOwn][TL::kCols / 2], dv_acc[CO::kOwn][TL::kCols / 2];
#pragma unroll
  for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
    for (int i = 0; i < TL::kCols / 2; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_start + it * kRows;
    const int st = it & 1;
    __syncthreads();  // tile it - 1's products are done: its stage is free
    if (it + 1 < n_q) {
      const int nx = st ^ 1;
      load_tile<T, D>(qs(nx), q + base, q0 + kRows, t, tid);
      load_tile<T, D>(dos(nx), dout + base, q0 + kRows, t, tid);
      load_row_stats(stats + 512 * nx, stats + 512 * nx + 256, lse, delta,
                     row_base, q0 + kRows, t, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it landed
    fence_proxy_async();
    __syncthreads();

    float s_t[32] = {}, dp_t[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T, 0, 0>(s_t, TL::k_major(ks, kk), TL::k_major(qs(st), kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T, 0, 0>(dp_t, TL::k_major(vs, kk), TL::k_major(dos(st), kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_t);
    fence_regs(dp_t);

    const bool edge =
        (causal && q0 == k0) || q0 + kRows > t || k0 + kRows > t;
    const float* lse_s = stats_f + 128 * st;
    uint32_t p_t[4][4], ds_t[4][4];
    if (use_exp2)
      bwd_probs<T, true>(s_t, dp_t, lse_s, lse_s + kRows, p_t, ds_t, edge,
                      k0 + r0, q0, cq, t, causal, sscale);
    else
      bwd_probs<T, false>(s_t, dp_t, lse_s, lse_s + kRows, p_t, ds_t, edge,
                       k0 + r0, q0, cq, t, causal, sscale);
    if constexpr (kDq) {
      // dS^T into its tile: fragment j of k step kk is row r0 + 8 (j & 1),
      // column 16 kk + 8 (j >> 1) + cq.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st_shared(dss + Tile<64>::offset(r0 + 8 * (j & 1),
                                           16 * kk + 8 * (j >> 1) + cq),
                    ds_t[kk][j]);
    }

    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, TL::kCols, 1>(dv_acc[b], p_t[kk],
                               TL::mn_major(dos(st), b0 + b, kk), 1);
#pragma unroll
    for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, TL::kCols, 1>(dk_acc[b], ds_t[kk],
                               TL::mn_major(qs(st), b0 + b, kk), 1);
    wgmma_commit();

    if constexpr (kDq) {
      fence_proxy_async();
      __syncthreads();  // the whole dS^T tile is written
      // dQ = dS K a column block at a time (fewer live registers at D 128),
      // rows q0 + r0 (+ 8), added into dq_acc.
#pragma unroll
      for (int bb = 0; bb < CO::kOwn; ++bb) {
        const int b = b0 + bb;
        float dq[TL::kCols / 2] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T, TL::kCols, 1, 1>(dq, Tile<64>::mn_major(dss, 0, kk),
                                    TL::mn_major(ks, b, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        // Lanes 2j and 2j + 1 hold columns c, c + 1 and c + 2, c + 3 of
        // rows r0 and r0 + 8: they swap halves so that each adds four
        // consecutive values of one row, the even lane row r0, the odd one
        // row r0 + 8.
        const bool odd = tid & 1;
        const int rl = r0 + (odd ? 8 : 0);
#pragma unroll
        for (int i = 0; i < TL::kCols / 2; i += 4) {
          const float x = __shfl_xor_sync(0xffffffffu, odd ? dq[i] : dq[i + 2], 1);
          const float y = __shfl_xor_sync(0xffffffffu, odd ? dq[i + 1] : dq[i + 3], 1);
          const float4 add =
              odd ? make_float4(scale * x, scale * y, scale * dq[i + 2],
                                scale * dq[i + 3])
                  : make_float4(scale * dq[i], scale * dq[i + 1], scale * x,
                                scale * y);
          const int col = b * TL::kCols + 8 * (i / 4) + cq - (odd ? 2 : 0);
          if (q0 + rl < t)
            atomicAdd(reinterpret_cast<float4*>(dq_acc + base +
                                                (size_t)(q0 + rl) * D + col),
                      add);
        }
      }
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_t);
    fence_regs(ds_t);
  }

#pragma unroll
  for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
    for (int i = 0; i < TL::kCols / 2; i += 2) {
      const int key = k0 + r0 + 8 * ((i >> 1) & 1);
      if (key >= t) continue;
      const size_t off =
          base + (size_t)key * D + (b0 + b) * TL::kCols + 8 * (i / 4) + cq;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack2<T>(scale * dk_acc[b][i], scale * dk_acc[b][i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack2<T>(dv_acc[b][i], dv_acc[b][i + 1]);
    }
}

template <typename T, int D, bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq_acc, void* dk,
               void* dv, int bh, int t, int causal, int use_exp2, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D, kDq>();
  unsigned blocks;
  if (int e = flash::blocks_for(t, kRows, bh * Cols<D>::kParts, &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T, D, kDq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<T, D, kDq><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), bh, t, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ backward, dq only (K4a)

// dS of one (q tile, k tile) pair as A fragments, from the S and dP
// accumulators (queries by rows, keys by columns): p = exp(s scale - lse)
// for the thread's rows r0 and r0 + 8 (lse times log2(e) with kExp2), zero
// outside the mask on edge tiles, then dS = p (dp - delta) rounded to T.
template <typename T, bool kExp2>
__device__ __forceinline__ void dq_probs(float (&s)[32], const float (&dp)[32],
                                         const float (&lse)[2],
                                         const float (&delta)[2],
                                         uint32_t (&ds)[4][4], bool edge,
                                         int row0, int col0, int t, int causal,
                                         float sscale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float p = softmax_exp<kExp2>(s[i] * sscale - lse[h]);
    if (edge) {
      const int col = col0 + 8 * (i / 4) + (i & 1);
      if (col >= t || (causal && col > row0 + 8 * h)) p = 0.f;
    }
    s[i] = p * (dp[i] - delta[h]);
  }
  to_a_fragments<T>(s, ds);
}

// Shared memory: Q, dO, then two stages of (K, V); 1024 bytes of alignment.
template <int D>
constexpr size_t dq_smem_bytes() {
  return 6 * (size_t)Tile<D>::kBytes + 1024;
}

// dQ of one 64-row q tile over its live k tiles (K4a), the forward's loop
// with one more product: S = Q K^T and dP = dO V^T (A and B K-major from
// shared memory), dS rounded into A fragments in place, dQ += dS K with B
// = K MN-major, as P V in the forward. dQ stays in registers and is
// written once, scaled, in T: no atomics, so the same bits every run.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int bh_count, int t, int causal,
          int use_exp2, float scale) {
  using TL = Tile<D>;
  using CO = Cols<D>;
  extern __shared__ uint8_t smem[];
  const uint32_t qs = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t dos = qs + TL::kBytes;
  auto ks = [&](int st) { return qs + (2 + 2 * st) * TL::kBytes; };
  auto vs = [&](int st) { return qs + (3 + 2 * st) * TL::kBytes; };

  const int nq = (t + kRows - 1) / kRows;
  const int bh = blockIdx.x % bh_count;
  const int b0 = (blockIdx.x / bh_count) % CO::kParts * CO::kOwn;
  const int q0 = (nq - 1 - blockIdx.x / (bh_count * CO::kParts)) * kRows;  // heaviest first
  const size_t base = (size_t)bh * t * D;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int cq = 2 * (tid % 4);
  const float sscale = use_exp2 ? scale * kLog2e : scale;
  const int k_end = causal ? min(t, q0 + kRows) : t;
  const int nk = (k_end + kRows - 1) / kRows;

  load_tile<T, D>(qs, q + base, q0, t, tid);
  load_tile<T, D>(dos, dout + base, q0, t, tid);
  load_tile<T, D>(ks(0), k + base, 0, t, tid);
  load_tile<T, D>(vs(0), v + base, 0, t, tid);
  cp_async_commit();

  // lse and delta of rows r0 and r0 + 8; rows past t read as zeros.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    const size_t at = (size_t)bh * t + (row < t ? row : 0);
    const float l = row < t ? lse[at] : 0.f;
    lse_r[h] = use_exp2 ? l * kLog2e : l;
    delta_r[h] = row < t ? delta[at] : 0.f;
  }

  float acc[CO::kOwn][TL::kCols / 2];
#pragma unroll
  for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
    for (int i = 0; i < TL::kCols / 2; ++i) acc[b][i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kRows;
    __syncthreads();  // tile j - 1's products are done: its stage is free
    if (j + 1 < nk) {
      load_tile<T, D>(ks((j + 1) & 1), k + base, k0 + kRows, t, tid);
      load_tile<T, D>(vs((j + 1) & 1), v + base, k0 + kRows, t, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();

    float s[32] = {}, dp[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T, 0, 0>(s, TL::k_major(qs, kk), TL::k_major(ks(j & 1), kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T, 0, 0>(dp, TL::k_major(dos, kk), TL::k_major(vs(j & 1), kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = (causal && k0 == q0) || k0 + kRows > t;
    uint32_t ds[4][4];
    if (use_exp2)
      dq_probs<T, true>(s, dp, lse_r, delta_r, ds, edge, q0 + r0, k0 + cq, t,
                     causal, sscale);
    else
      dq_probs<T, false>(s, dp, lse_r, delta_r, ds, edge, q0 + r0, k0 + cq, t,
                      causal, sscale);

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, TL::kCols, 1>(acc[b], ds[kk],
                               TL::mn_major(ks(j & 1), b0 + b, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int b = 0; b < CO::kOwn; ++b)
#pragma unroll
      for (int i = 2 * h; i < TL::kCols / 2; i += 4) {
        const int col = (b0 + b) * TL::kCols + 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * D + col) =
            pack2<T>(scale * acc[b][i], scale * acc[b][i + 1]);
      }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int t,
              int causal, int use_exp2, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  unsigned blocks;
  if (int e = flash::blocks_for(t, kRows, bh * Cols<D>::kParts, &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), bh, t, causal, use_exp2, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------ head dims above 256 (any d)
//
// Above 256 the tiles above no longer fit: one 64-row Q tile and one K
// tile at d 512 are 64 KB each, and double-buffered K and V pass the
// 227 KB a block may have. These kernels take d as a runtime argument, a
// multiple of 64 (the wrapper zero-pads up to it), and stream d:
//   - the score products (S, and dP in the backward) run over d in slabs
//     of 64 columns, each slab's Q and K (and dO, V) tiles loaded by
//     cp.async into a two-stage ring and multiplied by wgmma into the same
//     S (and dP) accumulators;
//   - each block owns 64 output columns (O; dK and dV, K3's dQ; K4a's dQ),
//     so the grid has d / 64 parts per 64-row tile, each of which computes
//     the whole S over d and reads only its own columns of V (forward),
//     of Q and dO (dK, dV) and of K (dQ).
// Shared memory and registers do not grow with d (39-97 KB; the
// accumulators of d 64); the parts recompute S (and dP) d / 64 times, so
// these kernels are correct at any d and slow: no configuration of the
// repo runs a head dim above 256. The d <= 256 kernels above are not
// touched.

// Rows [row0, row0 + 64) and the 64 columns from g of a matrix of row
// stride ld into a Tile<64>, asynchronously; rows at or past t read as
// zeros.
template <typename T>
__device__ __forceinline__ void load_slab(uint32_t tile, const T* g, int row0,
                                          int t, int ld, int tid) {
  constexpr int kChunksPerRow = kSlab / 8;
#pragma unroll
  for (int i = tid; i < kRows * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 8;
    const bool in = row0 + r < t;
    cp_async16(tile + Tile<kSlab>::offset(r, c),
               g + (size_t)(in ? row0 + r : 0) * ld + c, in ? 16 : 0);
  }
}

// Shared memory: two stages of (Q, K) slabs, then V's owned columns.
constexpr size_t fwd_wide_smem_bytes() {
  return 5 * (size_t)Tile<kSlab>::kBytes + 1024;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int bh_count, int t, int d,
                int causal, int use_exp2, float scale) {
  using TL = Tile<kSlab>;
  extern __shared__ uint8_t smem[];
  const uint32_t s0 = (smem_u32(smem) + 1023) & ~1023u;
  auto qs = [&](int st) { return s0 + (2 * st) * TL::kBytes; };
  auto ks = [&](int st) { return s0 + (2 * st + 1) * TL::kBytes; };
  const uint32_t vs = s0 + 4 * TL::kBytes;

  const int parts = d / kSlab;
  const int nq = (t + kRows - 1) / kRows;
  const int bh = blockIdx.x % bh_count;
  const int part = (blockIdx.x / bh_count) % parts;
  const int col0 = part * kSlab;  // the block's output columns
  const int q0 = (nq - 1 - blockIdx.x / (bh_count * parts)) * kRows;  // heaviest first
  const size_t base = (size_t)bh * t * d;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int cq = 2 * (tid % 4);
  const float sscale = use_exp2 ? scale * kLog2e : scale;
  const int k_end = causal ? min(t, q0 + kRows) : t;
  const int nk = (k_end + kRows - 1) / kRows;

  float o[1][TL::kCols / 2] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kRows;
    __syncthreads();  // tile j - 1's products are done: every stage is free
    load_slab<T>(qs(0), q + base, q0, t, d, tid);
    load_slab<T>(ks(0), k + base, k0, t, d, tid);
    load_slab<T>(vs, v + base + col0, k0, t, d, tid);
    cp_async_commit();

    float s[32] = {};
    for (int sl = 0; sl < parts; ++sl) {
      const int st = sl & 1;
      if (sl > 0) __syncthreads();  // slab sl - 1's product is done
      if (sl + 1 < parts) {
        load_slab<T>(qs(st ^ 1), q + base + (sl + 1) * kSlab, q0, t, d, tid);
        load_slab<T>(ks(st ^ 1), k + base + (sl + 1) * kSlab, k0, t, d, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // slab sl (and V) landed
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wgmma_ss_n64<T, 0, 0>(s, TL::k_major(qs(st), kk), TL::k_major(ks(st), kk),
                              sl > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }

    const bool edge = (causal && k0 == q0) || k0 + kRows > t;
    uint32_t p[4][4];
    if (use_exp2)
      fwd_softmax<T, true, kSlab>(s, m, l, o, p, edge, q0 + r0, k0 + cq, t,
                                  causal, sscale);
    else
      fwd_softmax<T, false, kSlab>(s, m, l, o, p, edge, q0 + r0, k0 + cq, t,
                                   causal, sscale);

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, TL::kCols, 1>(o[0], p[kk], TL::mn_major(vs, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const int row = q0 + r0 + 8 * h;
    if (row >= t) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int i = 2 * h; i < TL::kCols / 2; i += 4) {
      const int col = col0 + 8 * (i / 4) + cq;
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * d + col) =
          pack2<T>(o[0][i] * inv, o[0][i + 1] * inv);
    }
    if (cq == 0 && part == 0) {
      const float lm = fmaxf(l[h], 1e-30f);
      lse[(size_t)bh * t + row] =
          use_exp2 ? (m[h] + log2f(lm)) / kLog2e : m[h] + logf(lm);
    }
  }
}

template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* out,
                    float* lse, int bh, int t, int d, int causal,
                    int use_exp2, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_wide_smem_bytes();
  unsigned blocks;
  if (d % kSlab) return (int)cudaErrorInvalidValue;
  if (int e = flash::blocks_for(t, kRows, bh * (d / kSlab), &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_wide_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, bh, t, d, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

// Shared memory: two stages of (K, V, Q, dO) slabs; the owned columns of Q
// and dO (for dK and dV) and of K (for dQ); with kDq the dS^T tile; lse and
// delta; 1024 bytes of alignment.
template <bool kDq>
constexpr size_t bwd_wide_smem_bytes() {
  return (11 + (kDq ? 1 : 0)) * (size_t)Tile<kSlab>::kBytes +
         2 * kRows * sizeof(float) + 1024;
}

// bwd_kernel's function at any d (multiple of 64): dK and dV of one 64-key
// tile's owned columns over the live q tiles, with kDq (K3) dQ's owned
// columns added into dq_acc.
template <typename T, bool kDq>
__global__ void __launch_bounds__(kThreads)
bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq_acc, T* __restrict__ dk,
                T* __restrict__ dv, int bh_count, int t, int d, int causal,
                int use_exp2, float scale) {
  using TL = Tile<kSlab>;
  extern __shared__ uint8_t smem[];
  const uint32_t s0 = (smem_u32(smem) + 1023) & ~1023u;
  // Stage st: K, V, Q, dO slabs at s0 + (4 st + 0..3) tiles.
  auto slab = [&](int st, int i) { return s0 + (4 * st + i) * TL::kBytes; };
  const uint32_t qo = s0 + 8 * TL::kBytes;   // Q's owned columns
  const uint32_t doo = s0 + 9 * TL::kBytes;  // dO's owned columns
  const uint32_t ko = s0 + 10 * TL::kBytes;  // K's owned columns
  const uint32_t dss = s0 + 11 * TL::kBytes;  // dS^T [key][query], kDq only
  const uint32_t stats = dss + (kDq ? TL::kBytes : 0);  // lse, then delta
  const float* stats_f =
      reinterpret_cast<const float*>(smem + (stats - smem_u32(smem)));

  const int parts = d / kSlab;
  const int bh = blockIdx.x % bh_count;
  const int col0 = (blockIdx.x / bh_count) % parts * kSlab;
  const int k0 = (blockIdx.x / (bh_count * parts)) * kRows;  // heaviest (k0 = 0) first
  const size_t base = (size_t)bh * t * d;
  const size_t row_base = (size_t)bh * t;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int cq = 2 * (tid % 4);
  const float sscale = use_exp2 ? scale * kLog2e : scale;
  const int q_start = causal ? k0 : 0;
  const int n_q = (t - q_start + kRows - 1) / kRows;
  const T* srcs[4] = {k, v, q, dout};

  if constexpr (kDq) load_slab<T>(ko, k + base + col0, k0, t, d, tid);

  float dk_acc[1][TL::kCols / 2] = {}, dv_acc[1][TL::kCols / 2] = {};

  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_start + it * kRows;
    __syncthreads();  // tile it - 1's products are done: every stage is free
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_slab<T>(slab(0, i), srcs[i] + base, i < 2 ? k0 : q0, t, d, tid);
    load_slab<T>(qo, q + base + col0, q0, t, d, tid);
    load_slab<T>(doo, dout + base + col0, q0, t, d, tid);
    load_row_stats(stats, stats + 256, lse, delta, row_base, q0, t, tid);
    cp_async_commit();

    float s_t[32] = {}, dp_t[32] = {};
    for (int sl = 0; sl < parts; ++sl) {
      const int st = sl & 1;
      if (sl > 0) __syncthreads();  // slab sl - 1's products are done
      if (sl + 1 < parts) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_slab<T>(slab(st ^ 1, i), srcs[i] + base + (sl + 1) * kSlab,
                       i < 2 ? k0 : q0, t, d, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // slab sl (and the tile's owned columns) landed
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wgmma_ss_n64<T, 0, 0>(s_t, TL::k_major(slab(st, 0), kk),
                              TL::k_major(slab(st, 2), kk), sl > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wgmma_ss_n64<T, 0, 0>(dp_t, TL::k_major(slab(st, 1), kk),
                              TL::k_major(slab(st, 3), kk), sl > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_t);
      fence_regs(dp_t);
    }

    const bool edge =
        (causal && q0 == k0) || q0 + kRows > t || k0 + kRows > t;
    uint32_t p_t[4][4], ds_t[4][4];
    if (use_exp2)
      bwd_probs<T, true>(s_t, dp_t, stats_f, stats_f + kRows, p_t, ds_t, edge,
                         k0 + r0, q0, cq, t, causal, sscale);
    else
      bwd_probs<T, false>(s_t, dp_t, stats_f, stats_f + kRows, p_t, ds_t, edge,
                          k0 + r0, q0, cq, t, causal, sscale);
    if constexpr (kDq) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st_shared(dss + TL::offset(r0 + 8 * (j & 1),
                                     16 * kk + 8 * (j >> 1) + cq),
                    ds_t[kk][j]);
    }

    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, TL::kCols, 1>(dv_acc[0], p_t[kk], TL::mn_major(doo, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, TL::kCols, 1>(dk_acc[0], ds_t[kk], TL::mn_major(qo, 0, kk), 1);
    wgmma_commit();

    if constexpr (kDq) {
      fence_proxy_async();
      __syncthreads();  // the whole dS^T tile is written
      float dq[TL::kCols / 2] = {};
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<T, TL::kCols, 1, 1>(dq, TL::mn_major(dss, 0, kk),
                                     TL::mn_major(ko, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      // As bwd_kernel: lanes 2j and 2j + 1 swap halves so that each adds
      // four consecutive values of one row.
      const bool odd = tid & 1;
      const int rl = r0 + (odd ? 8 : 0);
#pragma unroll
      for (int i = 0; i < TL::kCols / 2; i += 4) {
        const float x = __shfl_xor_sync(0xffffffffu, odd ? dq[i] : dq[i + 2], 1);
        const float y = __shfl_xor_sync(0xffffffffu, odd ? dq[i + 1] : dq[i + 3], 1);
        const float4 add =
            odd ? make_float4(scale * x, scale * y, scale * dq[i + 2],
                              scale * dq[i + 3])
                : make_float4(scale * dq[i], scale * dq[i + 1], scale * x,
                              scale * y);
        const int col = col0 + 8 * (i / 4) + cq - (odd ? 2 : 0);
        if (q0 + rl < t)
          atomicAdd(reinterpret_cast<float4*>(dq_acc + base +
                                              (size_t)(q0 + rl) * d + col),
                    add);
      }
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_t);
    fence_regs(ds_t);
  }

#pragma unroll
  for (int i = 0; i < TL::kCols / 2; i += 2) {
    const int key = k0 + r0 + 8 * ((i >> 1) & 1);
    if (key >= t) continue;
    const size_t off = base + (size_t)key * d + col0 + 8 * (i / 4) + cq;
    *reinterpret_cast<uint32_t*>(dk + off) =
        pack2<T>(scale * dk_acc[0][i], scale * dk_acc[0][i + 1]);
    *reinterpret_cast<uint32_t*>(dv + off) =
        pack2<T>(dv_acc[0][i], dv_acc[0][i + 1]);
  }
}

template <typename T, bool kDq>
int launch_bwd_wide(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dq_acc, void* dk, void* dv, int bh, int t, int d,
                    int causal, int use_exp2, float scale,
                    cudaStream_t stream) {
  constexpr size_t smem = bwd_wide_smem_bytes<kDq>();
  unsigned blocks;
  if (d % kSlab) return (int)cudaErrorInvalidValue;
  if (int e = flash::blocks_for(t, kRows, bh * (d / kSlab), &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_wide_kernel<T, kDq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_wide_kernel<T, kDq><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), bh, t, d, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

// Shared memory: two stages of (Q, dO, K, V) slabs, then K's owned
// columns; 1024 bytes of alignment.
constexpr size_t dq_wide_smem_bytes() {
  return 9 * (size_t)Tile<kSlab>::kBytes + 1024;
}

// dq_kernel's function at any d (multiple of 64): dQ's owned columns of one
// 64-row q tile over its live k tiles, written once (no atomics).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int bh_count, int t, int d, int causal,
               int use_exp2, float scale) {
  using TL = Tile<kSlab>;
  extern __shared__ uint8_t smem[];
  const uint32_t s0 = (smem_u32(smem) + 1023) & ~1023u;
  // Stage st: Q, dO, K, V slabs at s0 + (4 st + 0..3) tiles.
  auto slab = [&](int st, int i) { return s0 + (4 * st + i) * TL::kBytes; };
  const uint32_t ko = s0 + 8 * TL::kBytes;  // K's owned columns

  const int parts = d / kSlab;
  const int nq = (t + kRows - 1) / kRows;
  const int bh = blockIdx.x % bh_count;
  const int col0 = (blockIdx.x / bh_count) % parts * kSlab;
  const int q0 = (nq - 1 - blockIdx.x / (bh_count * parts)) * kRows;  // heaviest first
  const size_t base = (size_t)bh * t * d;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int cq = 2 * (tid % 4);
  const float sscale = use_exp2 ? scale * kLog2e : scale;
  const int k_end = causal ? min(t, q0 + kRows) : t;
  const int nk = (k_end + kRows - 1) / kRows;
  const T* srcs[4] = {q, dout, k, v};

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    const size_t at = (size_t)bh * t + (row < t ? row : 0);
    const float l = row < t ? lse[at] : 0.f;
    lse_r[h] = use_exp2 ? l * kLog2e : l;
    delta_r[h] = row < t ? delta[at] : 0.f;
  }

  float acc[1][TL::kCols / 2] = {};

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kRows;
    __syncthreads();  // tile j - 1's products are done: every stage is free
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_slab<T>(slab(0, i), srcs[i] + base, i < 2 ? q0 : k0, t, d, tid);
    load_slab<T>(ko, k + base + col0, k0, t, d, tid);
    cp_async_commit();

    float s[32] = {}, dp[32] = {};
    for (int sl = 0; sl < parts; ++sl) {
      const int st = sl & 1;
      if (sl > 0) __syncthreads();  // slab sl - 1's products are done
      if (sl + 1 < parts) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_slab<T>(slab(st ^ 1, i), srcs[i] + base + (sl + 1) * kSlab,
                       i < 2 ? q0 : k0, t, d, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // slab sl (and K's owned columns) landed
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wgmma_ss_n64<T, 0, 0>(s, TL::k_major(slab(st, 0), kk),
                              TL::k_major(slab(st, 2), kk), sl > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wgmma_ss_n64<T, 0, 0>(dp, TL::k_major(slab(st, 1), kk),
                              TL::k_major(slab(st, 3), kk), sl > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    }

    const bool edge = (causal && k0 == q0) || k0 + kRows > t;
    uint32_t ds[4][4];
    if (use_exp2)
      dq_probs<T, true>(s, dp, lse_r, delta_r, ds, edge, q0 + r0, k0 + cq, t,
                        causal, sscale);
    else
      dq_probs<T, false>(s, dp, lse_r, delta_r, ds, edge, q0 + r0, k0 + cq, t,
                         causal, sscale);

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, TL::kCols, 1>(acc[0], ds[kk], TL::mn_major(ko, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int i = 2 * h; i < TL::kCols / 2; i += 4) {
      const int col = col0 + 8 * (i / 4) + cq;
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * d + col) =
          pack2<T>(scale * acc[0][i], scale * acc[0][i + 1]);
    }
  }
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int t, int d, int causal, int use_exp2,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_wide_smem_bytes();
  unsigned blocks;
  if (d % kSlab) return (int)cudaErrorInvalidValue;
  if (int e = flash::blocks_for(t, kRows, bh * (d / kSlab), &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_wide_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), bh, t, d, causal, use_exp2, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_wgmma
