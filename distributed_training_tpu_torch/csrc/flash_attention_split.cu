// The split flash-attention backward for Hopper (sm_90a): dQ (K4a) and
// dK, dV (K4b) in two launches, on [BH, T, D] tensors in float32,
// bfloat16 or float16 (the 16-bit types on the tensor cores).
//
// Replaces the two Pallas kernels of _flash_bwd_split in
// distributed_training_tpu/ops/flash_attention.py, which the JAX package
// runs under its _USE_SPLIT_BWD switch (tools/flash_kernel_bench.py
// --split-bwd):
//   - flash_wgmma::dq_kernel<T, D> (bf16, fp16; flash_wgmma.cuh) and
//     flash_bwd_dq_kernel<float, D> (below)  <- _dq_kernel
//     (flash_attention.py:212): one block per (bh, 64-row q tile) sweeps
//     the live k tiles; dq accumulates in float32 registers and is written
//     once in q's dtype. No atomics and no zeroed float32 buffer, so dq is
//     the same bit for bit from run to run (K3 adds its dq parts with
//     atomics in an order that changes). In bf16 it is the forward's loop
//     on the tensor cores with one more product (redesigned; 1.3209 ms
//     before, on CUDA cores);
//   - flash_wgmma::bwd_kernel<T, D, false> (bf16, fp16; flash_wgmma.cuh) and
//     flash_bwd_kernel<float, D, false> (flash_tiles.cuh)  <- _dkv_kernel
//     (flash_attention.py:243): one block per (bh, 64-row k tile) sweeps
//     the q tiles from the diagonal; dk and dv in registers, written once.
//     It is K3's loop without the dq part, on the tensor cores in bf16 as
//     K3 is (redesigned with it; 2.1614 ms before, on CUDA cores).
// delta = rowsum(dO * out) - g_lse is computed once by the caller and read
// by both. use_exp2 as in flash_tiles.cuh.
//
// Numerics as the Pallas kernels: p = exp(s - lse) recomputed from the
// saved lse; p is rounded to the input dtype before P^T dO, dS before
// dS K and dS^T Q (_dq_kernel:233-236, _dkv_kernel:262-272).
//
// What bounds it on an H100 80GB HBM3 at its 700 W limit (989 TFLOP/s bf16
// tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s), at the
// GPT-2-small shape (BH 192, T 1024, D 64, causal, bf16; 100.8 M unmasked
// (q, k) pairs): K4a does s, dp and dS K, 6 D operations a pair, 38.7
// GFLOP (0.0391 ms), and moves q, k, v, dO, lse, delta and dq, 127.4 MB
// (0.0380 ms): bound by operations at 0.0391 ms. K4b does s, dp, p^T dO
// and dS^T Q, 8 D a pair, 51.6 GFLOP (0.0522 ms), against 152.6 MB
// (0.0455 ms): operations, 0.0522 ms. The split recomputes s, p and dp in
// both kernels, 14 D operations a pair against K3's 10 D; the pair
// computes K3's function, so its bound is K3's, 0.0652 ms. In bf16 both
// run every product on the tensor cores (wgmma); in float32 both run them
// as float32 FMAs on CUDA cores (ceiling: 67 TFLOP/s float32).
//
// C interface (bound with ctypes): each entry launches once on the given
// stream and returns cudaGetLastError().

#include "flash_wgmma.cuh"

namespace {

using namespace flash;

template <int D, int R>
constexpr size_t dq_smem_bytes() {
  return ((size_t)4 * R * (D + kPad) + (size_t)R * (R + kPad) + 2 * R) *
         sizeof(float);
}

// dS of one (q tile, k tile) pair into shared memory, from s and dp for
// queries ty + 16 i, keys tx + 16 j.
template <bool kExp2, typename T, int kN>
__device__ __forceinline__ void dq_probs(const float (&s)[kN][kN],
                                         const float (&dp)[kN][kN],
                                         const float* lse_s,
                                         const float* delta_s, float* dss,
                                         int q0, int k0, int t, int causal,
                                         float sscale) {
  constexpr int kLdk = 16 * kN + kPad;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int ql = ty + 16 * i;
    const int row = q0 + ql;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int kl = tx + 16 * j;
      const int col = k0 + kl;
      float p = 0.f;
      if (row < t && col < t && !(causal && col > row))
        p = softmax_exp<kExp2>(s[i][j] * sscale - lse_s[ql]);
      dss[ql * kLdk + kl] = Elem<T>::round(p * (dp[i][j] - delta_s[ql]));
    }
  }
}

// K4a in float32 (bf16 takes flash_wgmma::dq_kernel).
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int bh_count, int t, int causal, int use_exp2,
                    float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kLdk = R + kPad;  // rows of dS: one per query
  constexpr int kN = R / 16;
  constexpr int kCpt = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + R * kLd;
  float* ks = dos + R * kLd;
  float* vs = ks + R * kLd;
  float* dss = vs + R * kLd;      // dS [R][kLdk]
  float* lse_s = dss + R * kLdk;  // [R]
  float* delta_s = lse_s + R;     // [R]

  const int nq = (t + R - 1) / R;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - blockIdx.x / bh_count) * R;  // heaviest first
  const size_t base = (size_t)bh * t * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float sscale = use_exp2 ? scale * kLog2e : scale;

  load_tile<T, D, R>(qs, q + base, q0, t);
  load_tile<T, D, R>(dos, dout + base, q0, t);
  load_row_stats<R>(lse_s, delta_s, lse, delta, (size_t)bh * t, q0, t,
                    use_exp2);

  float acc[kN][kCpt];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(t, q0 + R) : t;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the last tile's ks, vs, dss are read
    load_tile<T, D, R>(ks, k + base, k0, t);
    load_tile<T, D, R>(vs, v + base, k0, t);
    __syncthreads();

    // s = q k^T and dp = dO v^T for queries ty + 16 i, keys tx + 16 j.
    float s[kN][kN], dp[kN][kN];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[kN], dov[kN], kv[kN], vv[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        qv[i] = lds4(qs + (ty + 16 * i) * kLd + d);
        dov[i] = lds4(dos + (ty + 16 * i) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        kv[j] = lds4(ks + (tx + 16 * j) * kLd + d);
        vv[j] = lds4(vs + (tx + 16 * j) * kLd + d);
      }
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          s[i][j] = dot4(qv[i], kv[j], s[i][j]);
          dp[i][j] = dot4(dov[i], vv[j], dp[i][j]);
        }
    }

    if (use_exp2)
      dq_probs<true, T, kN>(s, dp, lse_s, delta_s, dss, q0, k0, t, causal,
                            sscale);
    else
      dq_probs<false, T, kN>(s, dp, lse_s, delta_s, dss, q0, k0, t, causal,
                             sscale);
    __syncthreads();

    // dq += dS K, rows ty + 16 i, columns tx * kCpt.
#pragma unroll 2
    for (int c0 = 0; c0 < R; c0 += 4) {
      float4 dsr[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) dsr[i] = lds4(dss + (ty + 16 * i) * kLdk + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float kv[kCpt];
        lds_row<kCpt>(kv, ks + (c0 + cc) * kLd + tx * kCpt);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float ds = comp(dsr[i], cc);
#pragma unroll
          for (int c = 0; c < kCpt; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    store_row<T, kCpt>(dq + base + (size_t)row * D + tx * kCpt, acc[i], scale);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int t,
              int causal, int use_exp2, float scale, cudaStream_t stream) {
  constexpr int R = rows_f32<D>;
  constexpr size_t smem = dq_smem_bytes<D, R>();
  unsigned blocks;
  if (int e = blocks_for(t, R, bh, &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, D, R><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), bh, t, causal, use_exp2, scale);
  return (int)cudaGetLastError();
}

// flash_bwd_dq_kernel's function at any d (multiple of 64; flash_tiles.cuh's
// d > 256 layout): dQ's owned 64 columns of one 64-row q tile, written once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int bh_count, int t, int d, int causal, int use_exp2,
                         float scale) {
  constexpr int R = kWideR;
  constexpr int kLd = kWideLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // slabs of Q, dO, K, V
  float* dos = qs + kWideTile;
  float* ks = dos + kWideTile;
  float* vs = ks + kWideTile;
  float* ko = vs + kWideTile;   // owned columns of K
  float* dss = ko + kWideTile;  // dS [query][key]
  float* lse_s = dss + kWideTile;
  float* delta_s = lse_s + R;

  const int parts = d / 64;
  const int nq = (t + R - 1) / R;
  const int bh = blockIdx.x % bh_count;
  const int col0 = (blockIdx.x / bh_count) % parts * 64;
  const int q0 = (nq - 1 - blockIdx.x / (bh_count * parts)) * R;  // heaviest first
  const size_t base = (size_t)bh * t * d;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float sscale = use_exp2 ? scale * kLog2e : scale;

  load_row_stats<R>(lse_s, delta_s, lse, delta, (size_t)bh * t, q0, t,
                    use_exp2);

  float acc[4][4] = {};
  const int k_end = causal ? min(t, q0 + R) : t;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < d; c += 64) {
      __syncthreads();  // the last slab (and dss, ko) is read
      load_slab<T>(qs, q + base + c, q0, t, d);
      load_slab<T>(dos, dout + base + c, q0, t, d);
      load_slab<T>(ks, k + base + c, k0, t, d);
      load_slab<T>(vs, v + base + c, k0, t, d);
      if (c == 0) load_slab<T>(ko, k + base + col0, k0, t, d);
      __syncthreads();
      slab_products(s, qs, ks);
      slab_products(dp, dos, vs);
    }

    if (use_exp2)
      dq_probs<true, T, 4>(s, dp, lse_s, delta_s, dss, q0, k0, t, causal,
                           sscale);
    else
      dq_probs<false, T, 4>(s, dp, lse_s, delta_s, dss, q0, k0, t, causal,
                            sscale);
    __syncthreads();

    // dq += dS K, rows ty + 16 i, owned columns tx * 4.
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
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ds, comp(kv, c), acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    store_row<T, 4>(dq + base + (size_t)row * d + col0 + tx * 4, acc[i], scale);
  }
}

// K4a at d > 256: flash_wgmma's tensor-core kernel for the 16-bit types,
// the CUDA-core one above for float32.
template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int t, int d, int causal, int use_exp2,
                   float scale, cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>) {
    return flash_wgmma::launch_dq_wide<T>(q, k, v, dout, lse, delta, dq, bh, t,
                                          d, causal, use_exp2, scale, stream);
  } else {
    constexpr size_t smem = ((size_t)6 * kWideTile + 2 * kWideR) * sizeof(float);
    unsigned blocks;
    if (d % 64) return (int)cudaErrorInvalidValue;
    if (int e = blocks_for(t, kWideR, bh * (d / 64), &blocks)) return e;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wide_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_wide_kernel<T><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), bh, t, d, causal, use_exp2, scale);
    return (int)cudaGetLastError();
  }
}

// K4b at d > 256, as launch_dq_wide.
template <typename T>
int dkv_wide(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv, int bh,
             int t, int d, int causal, int use_exp2, float scale,
             cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>)
    return flash_wgmma::launch_bwd_wide<T, false>(q, k, v, dout, lse, delta,
                                                  nullptr, dk, dv, bh, t, d,
                                                  causal, use_exp2, scale,
                                                  stream);
  else
    return launch_bwd_wide<T, false>(q, k, v, dout, lse, delta, nullptr, dk,
                                     dv, bh, t, d, causal, use_exp2, scale,
                                     stream);
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: [bh, t, d] contiguous, float32 (dtype = 0), bfloat16
// (dtype = 1) or float16 (dtype = 2), 16-byte aligned; lse, delta: [bh, t]
// float32.
// d: 32, 64, 128, 256 or any multiple of 64 above 256. scale: 1/sqrt(d)
// of the unpadded d.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int t, int d, int dtype, int causal,
                 int use_exp2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define DQ(T, D) \
  launch_dq<T, D>(q, k, v, dout, l, dl, dq, bh, t, causal, use_exp2, scale, s)
#define DQ_WGMMA(T, D)                                                      \
  flash_wgmma::launch_dq<T, D>(q, k, v, dout, l, dl, dq, bh, t, causal,        \
                            use_exp2, scale, s)
#define DQ_WIDE(T) \
  launch_dq_wide<T>(q, k, v, dout, l, dl, dq, bh, t, d, causal, use_exp2, scale, s)
  FLASH_DISPATCH(DQ_WGMMA, DQ, DQ_WIDE);
#undef DQ_WIDE
#undef DQ_WGMMA
#undef DQ
}

// As flash_bwd_dq, writing dk and dv ([bh, t, d], the inputs' dtype).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int t, int d, int dtype,
                  int causal, int use_exp2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define DKV(T, D)                                                           \
  launch_bwd<T, D, false>(q, k, v, dout, l, dl, nullptr, dk, dv, bh, t,     \
                          causal, use_exp2, scale, s)
#define DKV_WGMMA(T, D)                                                     \
  flash_wgmma::launch_bwd<T, D, false>(q, k, v, dout, l, dl, nullptr, dk, dv,  \
                                    bh, t, causal, use_exp2, scale, s)
#define DKV_WIDE(T)                                                         \
  dkv_wide<T>(q, k, v, dout, l, dl, dk, dv, bh, t, d, causal, use_exp2,      \
              scale, s)
  FLASH_DISPATCH(DKV_WGMMA, DKV, DKV_WIDE);
#undef DKV_WIDE
#undef DKV_WGMMA
#undef DKV
}

}  // extern "C"
