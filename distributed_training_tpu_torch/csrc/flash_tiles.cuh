// Tile helpers of the flash-attention kernels on CUDA cores, and the
// backward's k-tile loop, shared by flash_attention.cu (K2, K3) and
// flash_attention_split.cu (K4a, K4b). They run every float32
// instantiation; in bfloat16 and float16 all four run on the tensor cores
// (flash_wgmma.cuh).
//
// Layout common to all of them: one block of 256 threads (16 x 16) per
// (bh, R-row tile), R = 64 (rows_f32); tiles of R x D live in shared
// memory as float32 rows padded by 4 floats, so the float4 reads of the
// inner products hit distinct banks; each thread owns an R/16 x R/16
// block of an R x R score tile (rows ty + 16 i, columns tx + 16 j) and
// D / 16 columns of an R x D product. Rows and keys past T are masked, so
// any T is taken. At D 256 the tiles have R = 32 rows: the backward's four
// 64 x 260-float tiles alone would take 266 KB, above the 227 KB a block
// may have; at 32 rows K3 takes 147 KB.
//
// use_exp2 (the JAX package's _USE_EXP2 switch): log2(e) is folded into
// the score scale, the running max and sum of the forward and the
// recomputed p of the backward are in the log2 domain and use exp2f (the
// card's ex2); the stored lse stays a natural log. It is a runtime
// argument, uniform across the grid, not a template parameter of the
// kernels, so the number of instantiations stays the same. Each kernel
// branches on it once per tile, around the section that takes the
// exponentials (a helper templated on kExp2), so that with use_exp2 = 0
// the tile runs the instructions it ran before the switch existed.

#pragma once

#include "elem.cuh"

namespace flash {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Query and key rows of a float32 tile at head dim D (see above).
template <int D>
constexpr int rows_f32 = D > 128 ? 32 : 64;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// e^x, or 2^x when the scores carry log2(e) (use_exp2).
template <bool kExp2>
__device__ __forceinline__ float softmax_exp(float x) {
  return kExp2 ? exp2f(x) : expf(x);
}

// N consecutive floats of shared memory (N = D / 16: 2, 4, 8 or 16).
template <int N>
__device__ __forceinline__ void lds_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = lds4(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else {
    static_assert(N == 2, "columns per thread must be 2, 4, 8 or 16");
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

// N consecutive values of a row of global memory, from float32.
template <typename T, int N>
__device__ __forceinline__ void store_row(T* dst, const float (&src)[N],
                                          float mul) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      Elem<T>::store4(dst + i, make_float4(src[i] * mul, src[i + 1] * mul,
                                           src[i + 2] * mul, src[i + 3] * mul));
  } else {
    Elem<T>::store2(dst, src[0] * mul, src[1] * mul);
  }
}

// Rows [row0, row0 + R) of a [t, D] matrix into shared memory as float32,
// R rows of D + kPad; rows at or past t read as zeros. Coalesced: thread
// i takes the i-th group of 4 elements of the tile.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* s, const T* g, int row0,
                                          int t) {
  constexpr int kGroups = R * D / 4;
  for (int i = threadIdx.x; i < kGroups; i += kThreads) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t) v = Elem<T>::load4(g + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(s + r * (D + kPad) + c) = v;
  }
}

// lse (times log2(e) with use_exp2) and delta of the query rows
// [q0, q0 + R) into shared memory; rows past t read as zeros.
template <int R>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta,
                                               size_t row_base, int q0, int t,
                                               int use_exp2) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool in = q0 + i < t;
    const float l = in ? lse[row_base + q0 + i] : 0.f;
    lse_s[i] = use_exp2 ? l * kLog2e : l;
    delta_s[i] = in ? delta[row_base + q0 + i] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

inline int blocks_for(int t, int tile, int bh, unsigned* out) {
  const long long n = (long long)((t + tile - 1) / tile) * bh;
  if (t <= 0 || bh <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *out = (unsigned)n;
  return 0;
}

// ------------------------------------------------ backward, one k tile a block

template <int D, int R, bool kDq>
constexpr size_t bwd_smem_bytes() {
  return ((size_t)4 * R * (D + kPad) + (size_t)2 * R * (R + kPad) +
          (kDq ? (size_t)R * (R + kPad) : 0) + 2 * R) *
         sizeof(float);
}

// p^T (rounded), dS^T and, with kDq, dS of one (k tile, q tile) pair into
// shared memory, from s^T and dp^T for keys ty + 16 i, queries tx + 16 j.
template <bool kExp2, typename T, bool kDq, int R>
__device__ __forceinline__ void bwd_probs_t(const float (&st)[R / 16][R / 16],
                                            const float (&dpt)[R / 16][R / 16],
                                            const float* lse_s,
                                            const float* delta_s, float* pts,
                                            float* dsts, float* dss, int q0,
                                            int k0, int t, int causal,
                                            float sscale) {
  constexpr int kN = R / 16;
  constexpr int kLd = R + kPad;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int kl = ty + 16 * i;
    const int col = k0 + kl;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int ql = tx + 16 * j;
      const int row = q0 + ql;
      float p = 0.f;
      if (row < t && col < t && !(causal && col > row))
        p = softmax_exp<kExp2>(st[i][j] * sscale - lse_s[ql]);
      const float ds = Elem<T>::round(p * (dpt[i][j] - delta_s[ql]));
      pts[kl * kLd + ql] = Elem<T>::round(p);
      dsts[kl * kLd + ql] = ds;
      if constexpr (kDq) dss[ql * kLd + kl] = ds;
    }
  }
}

// dK and dV of one R-key tile, in registers over the live q tiles, written
// once. With kDq (K3) each q tile's dQ = dS K is also added with float32
// atomics into dq_acc; without it (K4b) dq_acc is not touched.
template <typename T, int D, bool kDq, int R>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int bh_count, int t,
                 int causal, int use_exp2, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kLdr = R + kPad;  // rows of p^T, dS^T (one per key), dS
  constexpr int kN = R / 16;
  constexpr int kCpt = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + R * kLd;
  float* qs = vs + R * kLd;
  float* dos = qs + R * kLd;
  float* pts = dos + R * kLd;     // p^T   [R][kLdr]
  float* dsts = pts + R * kLdr;   // dS^T  [R][kLdr]
  float* dss = dsts + R * kLdr;   // dS    [R][kLdr], with kDq only
  float* lse_s = dss + (kDq ? R * kLdr : 0);  // [R]
  float* delta_s = lse_s + R;                 // [R]

  const int bh = blockIdx.x % bh_count;
  const int k0 = (blockIdx.x / bh_count) * R;  // heaviest (k0 = 0) first
  const size_t base = (size_t)bh * t * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float sscale = use_exp2 ? scale * kLog2e : scale;

  load_tile<T, D, R>(ks, k + base, k0, t);
  load_tile<T, D, R>(vs, v + base, k0, t);

  float dk_acc[kN][kCpt], dv_acc[kN][kCpt];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int q_start = causal ? k0 : 0;
  for (int q0 = q_start; q0 < t; q0 += R) {
    __syncthreads();  // the last tile's qs, dos, pts, dsts, dss are read
    load_tile<T, D, R>(qs, q + base, q0, t);
    load_tile<T, D, R>(dos, dout + base, q0, t);
    load_row_stats<R>(lse_s, delta_s, lse, delta, (size_t)bh * t, q0, t,
                      use_exp2);
    __syncthreads();

    // s^T and dp^T for keys ty + 16 i, queries tx + 16 j.
    float st[kN][kN], dpt[kN][kN];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[kN], vv[kN], qv[kN], dov[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        kv[i] = lds4(ks + (ty + 16 * i) * kLd + d);
        vv[i] = lds4(vs + (ty + 16 * i) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        qv[j] = lds4(qs + (tx + 16 * j) * kLd + d);
        dov[j] = lds4(dos + (tx + 16 * j) * kLd + d);
      }
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          st[i][j] = dot4(kv[i], qv[j], st[i][j]);
          dpt[i][j] = dot4(vv[i], dov[j], dpt[i][j]);
        }
    }

    if (use_exp2)
      bwd_probs_t<true, T, kDq, R>(st, dpt, lse_s, delta_s, pts, dsts, dss,
                                   q0, k0, t, causal, sscale);
    else
      bwd_probs_t<false, T, kDq, R>(st, dpt, lse_s, delta_s, pts, dsts, dss,
                                    q0, k0, t, causal, sscale);
    __syncthreads();

    // dV += p^T dO and dK += dS^T Q, for keys ty + 16 i, columns tx * kCpt.
#pragma unroll 2
    for (int r = 0; r < R; r += 4) {
      float4 pv[kN], dsv[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        pv[i] = lds4(pts + (ty + 16 * i) * kLdr + r);
        dsv[i] = lds4(dsts + (ty + 16 * i) * kLdr + r);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float dov[kCpt], qv[kCpt];
        lds_row<kCpt>(dov, dos + (r + rr) * kLd + tx * kCpt);
        lds_row<kCpt>(qv, qs + (r + rr) * kLd + tx * kCpt);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float p = comp(pv[i], rr);
          const float ds = comp(dsv[i], rr);
#pragma unroll
          for (int c = 0; c < kCpt; ++c) {
            dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
          }
        }
      }
    }

    if constexpr (kDq) {
      // dQ of this tile, rows ty + 16 i, columns tx * kCpt: dS K, added
      // into the float32 buffer.
      float dq[kN][kCpt];
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) dq[i][c] = 0.f;
#pragma unroll 2
      for (int c0 = 0; c0 < R; c0 += 4) {
        float4 dsr[kN];
#pragma unroll
        for (int i = 0; i < kN; ++i)
          dsr[i] = lds4(dss + (ty + 16 * i) * kLdr + c0);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float kv[kCpt];
          lds_row<kCpt>(kv, ks + (c0 + cc) * kLd + tx * kCpt);
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            const float ds = comp(dsr[i], cc);
#pragma unroll
            for (int c = 0; c < kCpt; ++c) dq[i][c] = fmaf(ds, kv[c], dq[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= t) continue;
        float* dst = dq_acc + base + (size_t)row * D + tx * kCpt;
#pragma unroll
        for (int c = 0; c < kCpt; ++c) atomicAdd(dst + c, scale * dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= t) continue;
    const size_t off = base + (size_t)col * D + tx * kCpt;
    store_row<T, kCpt>(dk + off, dk_acc[i], scale);
    store_row<T, kCpt>(dv + off, dv_acc[i], 1.f);
  }
}

template <typename T, int D, bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq_acc, void* dk,
               void* dv, int bh, int t, int causal, int use_exp2, float scale,
               cudaStream_t stream) {
  constexpr int R = rows_f32<D>;
  constexpr size_t smem = bwd_smem_bytes<D, R, kDq>();
  unsigned blocks;
  if (int e = blocks_for(t, R, bh, &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D, kDq, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kernel<T, D, kDq, R><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), bh, t, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------ head dims above 256 (float32)
//
// As flash_wgmma.cuh's d > 256 kernels, on CUDA cores: d a runtime multiple
// of 64 (the wrapper pads), the score products run over d in slabs of 64
// columns through shared memory, and each block owns 64 output columns, so
// shared memory and registers do not grow with d and the parts recompute
// the scores. Tiles of kWideR = 64 rows, rows of 64 + kPad floats.
constexpr int kWideR = 64;
constexpr int kWideLd = 64 + kPad;
constexpr int kWideTile = kWideR * kWideLd;  // floats of one tile

// Rows [row0, row0 + 64) and the 64 columns from g of a matrix of row
// stride ld into shared memory as float32; rows at or past t read as zeros.
template <typename T>
__device__ __forceinline__ void load_slab(float* s, const T* g, int row0,
                                          int t, int ld) {
  for (int i = threadIdx.x; i < kWideR * 16; i += kThreads) {
    const int r = i / 16;
    const int c = (i % 16) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t) v = Elem<T>::load4(g + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<float4*>(s + r * kWideLd + c) = v;
  }
}

// acc[i][j] += row ty + 16 i of slab a . row tx + 16 j of slab b.
__device__ __forceinline__ void slab_products(float (&acc)[4][4],
                                              const float* a, const float* b) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < 64; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = lds4(a + (ty + 16 * i) * kWideLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = lds4(b + (tx + 16 * j) * kWideLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
  }
}

template <bool kDq>
constexpr size_t bwd_wide_smem_bytes() {
  return ((size_t)(kDq ? 10 : 8) * kWideTile + 2 * kWideR) * sizeof(float);
}

// flash_bwd_kernel's function at any d (multiple of 64): dK and dV of one
// 64-key tile's owned columns, with kDq (K3) dQ's added into dq_acc.
template <typename T, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_acc, T* __restrict__ dk,
                      T* __restrict__ dv, int bh_count, int t, int d,
                      int causal, int use_exp2, float scale) {
  constexpr int R = kWideR;
  constexpr int kLd = kWideLd;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // slabs of K, V, Q, dO
  float* vs = ks + kWideTile;
  float* qs = vs + kWideTile;
  float* dos = qs + kWideTile;
  float* qo = dos + kWideTile;   // owned columns of Q, dO
  float* doo = qo + kWideTile;
  float* pts = doo + kWideTile;  // p^T, dS^T [key][query]
  float* dsts = pts + kWideTile;
  float* dss = dsts + kWideTile;  // dS [query][key], kDq only
  float* ko = dss + kWideTile;    // owned columns of K, kDq only
  float* lse_s = dsts + (kDq ? 3 : 1) * kWideTile;
  float* delta_s = lse_s + R;

  const int parts = d / 64;
  const int bh = blockIdx.x % bh_count;
  const int col0 = (blockIdx.x / bh_count) % parts * 64;
  const int k0 = (blockIdx.x / (bh_count * parts)) * R;  // heaviest first
  const size_t base = (size_t)bh * t * d;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float sscale = use_exp2 ? scale * kLog2e : scale;

  if constexpr (kDq) load_slab<T>(ko, k + base + col0, k0, t, d);

  float dk_acc[4][4] = {}, dv_acc[4][4] = {};
  const int q_start = causal ? k0 : 0;
  for (int q0 = q_start; q0 < t; q0 += R) {
    float st[4][4] = {}, dpt[4][4] = {};
    for (int c = 0; c < d; c += 64) {
      __syncthreads();  // the last slab (and tile) is read
      load_slab<T>(ks, k + base + c, k0, t, d);
      load_slab<T>(vs, v + base + c, k0, t, d);
      load_slab<T>(qs, q + base + c, q0, t, d);
      load_slab<T>(dos, dout + base + c, q0, t, d);
      if (c == 0) {
        load_slab<T>(qo, q + base + col0, q0, t, d);
        load_slab<T>(doo, dout + base + col0, q0, t, d);
        load_row_stats<R>(lse_s, delta_s, lse, delta, (size_t)bh * t, q0, t,
                          use_exp2);
      }
      __syncthreads();
      slab_products(st, ks, qs);
      slab_products(dpt, vs, dos);
    }

    if (use_exp2)
      bwd_probs_t<true, T, kDq, R>(st, dpt, lse_s, delta_s, pts, dsts, dss,
                                   q0, k0, t, causal, sscale);
    else
      bwd_probs_t<false, T, kDq, R>(st, dpt, lse_s, delta_s, pts, dsts, dss,
                                    q0, k0, t, causal, sscale);
    __syncthreads();

    // dV += p^T dO and dK += dS^T Q, keys ty + 16 i, owned columns tx * 4.
#pragma unroll 2
    for (int r = 0; r < R; r += 4) {
      float4 pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = lds4(pts + (ty + 16 * i) * kLd + r);
        dsv[i] = lds4(dsts + (ty + 16 * i) * kLd + r);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 dov = lds4(doo + (r + rr) * kLd + tx * 4);
        const float4 qv = lds4(qo + (r + rr) * kLd + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(pv[i], rr);
          const float ds = comp(dsv[i], rr);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            dv_acc[i][cc] = fmaf(p, comp(dov, cc), dv_acc[i][cc]);
            dk_acc[i][cc] = fmaf(ds, comp(qv, cc), dk_acc[i][cc]);
          }
        }
      }
    }

    if constexpr (kDq) {
      // dQ of this tile, rows ty + 16 i, owned columns tx * 4: dS K.
      float dq[4][4] = {};
#pragma unroll 2
      for (int c0 = 0; c0 < R; c0 += 4) {
        float4 dsr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsr[i] = lds4(dss + (ty + 16 * i) * kLd + c0);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 kv = lds4(ko + (c0 + cc) * kLd + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = comp(dsr[i], cc);
#pragma unroll
            for (int c = 0; c < 4; ++c) dq[i][c] = fmaf(ds, comp(kv, c), dq[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= t) continue;
        float* dst = dq_acc + base + (size_t)row * d + col0 + tx * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(dst + c, scale * dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= t) continue;
    const size_t off = base + (size_t)key * d + col0 + tx * 4;
    store_row<T, 4>(dk + off, dk_acc[i], scale);
    store_row<T, 4>(dv + off, dv_acc[i], 1.f);
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
  if (d % 64) return (int)cudaErrorInvalidValue;
  if (int e = blocks_for(t, kWideR, bh * (d / 64), &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wide_kernel<T, kDq>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wide_kernel<T, kDq><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), bh, t, d, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// Dispatch on the element type and head dim: WGMMA(T, D) for bfloat16
// (dtype = 1, T __nv_bfloat16) and float16 (dtype = 2, T __half), F32(T,
// D) for float32 (dtype = 0), D 32, 64, 128 or 256; WIDE(T) (T float for
// float32) at any d above 256 (the d > 256 kernels; a d that is not a
// multiple of 64 is refused there); anything else is refused. It
// returns from the enclosing function on every path. The flash kernels
// send the 16-bit types to the tensor-core tiles of flash_wgmma.cuh and
// float32 to the CUDA-core loops above.
#define FLASH_DISPATCH(WGMMA, F32, WIDE)             \
  if (d > 256) {                                     \
    if (dtype == 1) return WIDE(__nv_bfloat16);      \
    if (dtype == 2) return WIDE(__half);             \
    if (dtype == 0) return WIDE(float);              \
  } else if (dtype == 1) {                           \
    if (d == 32) return WGMMA(__nv_bfloat16, 32);    \
    if (d == 64) return WGMMA(__nv_bfloat16, 64);    \
    if (d == 128) return WGMMA(__nv_bfloat16, 128);  \
    if (d == 256) return WGMMA(__nv_bfloat16, 256);  \
  } else if (dtype == 2) {                           \
    if (d == 32) return WGMMA(__half, 32);           \
    if (d == 64) return WGMMA(__half, 64);           \
    if (d == 128) return WGMMA(__half, 128);         \
    if (d == 256) return WGMMA(__half, 256);         \
  } else if (dtype == 0) {                           \
    if (d == 32) return F32(float, 32);              \
    if (d == 64) return F32(float, 64);              \
    if (d == 128) return F32(float, 128);            \
    if (d == 256) return F32(float, 256);            \
  }                                                  \
  return (int)cudaErrorInvalidValue
