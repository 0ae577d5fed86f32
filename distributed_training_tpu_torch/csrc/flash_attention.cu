// Flash attention for Hopper (sm_90a): the forward (K2) and the fused
// backward (K3), on [BH, T, D] tensors in float32, bfloat16 or float16 (the
// two 16-bit types on the tensor cores, flash_wgmma.cuh, one instantiation
// each).
//
// Replaces the Pallas kernels of distributed_training_tpu/ops/
// flash_attention.py:
//   - flash_wgmma::fwd_kernel<T, D> (bf16, fp16), flash_fwd_kernel<float,
//     D>  <- _flash_fwd (body _fwd_kernel): online-softmax attention,
//     causal tiles that are wholly masked skipped (_live_block); out in the input dtype and lse in float32, one value per row (the
//     TPU's LSE_LANES replication was a Mosaic layout rule, not part of
//     the function);
//   - flash_wgmma::bwd_kernel<T, D, true> (bf16, fp16), flash_bwd_kernel<
//     float, D, true> (flash_tiles.cuh)  <- _flash_bwd (body
//     _fused_bwd_kernel): dq, dk, dv from p = exp(s - lse) recomputed once
//     per tile and shared by the three products. delta = rowsum(dO * out)
//     - g_lse is a plain tensor op before the launch, as in _bwd_prologue.
// Both take use_exp2 (the JAX _USE_EXP2 switch, see flash_tiles.cuh).
//
// Same numerics as the TPU kernels: scores and every product accumulate in
// float32 from the stored (fp32, bf16 or fp16) values; masked scores are
// -1e30; p is rounded to the input dtype before it multiplies V (forward)
// or dO (backward), and dS before it multiplies Q or K; a row with l == 0
// writes 0 and lse = m + log(max(l, 1e-30)).
//
// What bounds it on an H100 80GB HBM3 at its 700 W limit (989 TFLOP/s bf16
// tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s): at the
// GPT-2-small shape (BH 192, T 1024, D 64, causal, bf16) the forward moves
// ~101 MB (0.030 ms) and does 25.8 GFLOP (0.026 ms), so it is bound by
// bytes at 0.0303 ms; the backward moves ~178 MB (0.053 ms) and does 64.5
// GFLOP (0.065 ms), so it is bound by operations at 0.0652 ms.
//
// bfloat16 (the GPT path) runs on the tensor cores: flash_wgmma.cuh holds
// both kernels (bf16 tiles in the swizzled layout wgmma reads, every
// product a wgmma with float32 accumulators, P and dS^T taken from
// registers, double-buffered cp.async loads, the mask only on diagonal and
// ragged tiles, dQ by float4 vector reductions). The first version, every
// product a float32 FMA on CUDA cores, took 0.9222 ms (K2) and 3.1057 ms
// (K3 through its wrapper; kernel 2.88 ms) at that shape on that card.
// float32 keeps that version (below and flash_tiles.cuh): on the tensor
// cores it would be TF32, and it is a checking path the trainer does not
// run. Its design:
//   - the k (or, backward, q) tiles are a loop inside the block, which
//     takes the place of the TPU's sequential grid axis, and the running
//     (m, l, acc) of the forward stay in registers across it;
//   - row max and sum reduce over the 16 lanes of a half warp by shuffles;
//   - causal: the forward stops at the last live k tile, the backward
//     starts at the first live q tile; blocks are ordered heaviest first
//     (both versions);
//   - dK and dV accumulate in registers over the q tiles; dQ, whose rows
//     are spread over all k-tile blocks, is added with float32 atomics
//     into one zeroed [BH, T, D] buffer (the TPU wrote [nk, BH, T, D]
//     partials, 0.8 GB per layer at this shape) and cast by the caller.
//
// C interface (bound with ctypes): each entry launches once on the given
// stream and returns cudaGetLastError().

#include "flash_wgmma.cuh"

namespace {

using namespace flash;

template <int D, int R>
constexpr size_t fwd_smem_bytes() {
  return ((size_t)3 * R * (D + kPad) + (size_t)R * (R + kPad)) * sizeof(float);
}

// One k tile's step of the online softmax for query rows ty + 16 i: the
// scores s (scaled and masked here), the running max m and sum l, the
// output accumulators o rescaled, and p (rounded) into shared memory.
template <bool kExp2, typename T, int kCpt, int kN>
__device__ __forceinline__ void online_softmax(float (&s)[kN][kN],
                                               float (&m)[kN], float (&l)[kN],
                                               float (&o)[kN][kCpt], float* ps,
                                               int q0, int k0, int t,
                                               int causal, float sscale) {
  constexpr int kLdp = 16 * kN + kPad;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int row = q0 + ty + 16 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int col = k0 + tx + 16 * j;
      float x = s[i][j] * sscale;
      if (col >= t || (causal && col > row)) x = kNegInf;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m[i], half_warp_max(mx));
    const float corr = softmax_exp<kExp2>(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float p = softmax_exp<kExp2>(s[i][j] - m_new);
      rs += p;
      ps[(ty + 16 * i) * kLdp + tx + 16 * j] = Elem<T>::round(p);
    }
    l[i] = l[i] * corr + half_warp_sum(rs);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) o[i][c] *= corr;
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int bh_count, int t, int causal,
                 int use_exp2, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kLdp = R + kPad;
  constexpr int kN = R / 16;    // score rows and columns per thread
  constexpr int kCpt = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + R * kLd;
  float* vs = ks + R * kLd;
  float* ps = vs + R * kLd;

  const int nq = (t + R - 1) / R;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - blockIdx.x / bh_count) * R;  // heaviest first
  const size_t base = (size_t)bh * t * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float sscale = use_exp2 ? scale * kLog2e : scale;

  load_tile<T, D, R>(qs, q + base, q0, t);

  float m[kN], l[kN], o[kN][kCpt];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) o[i][c] = 0.f;
  }

  const int k_end = causal ? min(t, q0 + R) : t;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the last tile's ks, vs, ps are read
    load_tile<T, D, R>(ks, k + base, k0, t);
    load_tile<T, D, R>(vs, v + base, k0, t);
    __syncthreads();

    float s[kN][kN];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kN], kv[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) qv[i] = lds4(qs + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kN; ++j) kv[j] = lds4(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int j = 0; j < kN; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    if (use_exp2)
      online_softmax<true, T, kCpt, kN>(s, m, l, o, ps, q0, k0, t, causal,
                                        sscale);
    else
      online_softmax<false, T, kCpt, kN>(s, m, l, o, ps, q0, k0, t, causal,
                                         sscale);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < R; j += 4) {
      float4 pv[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) pv[i] = lds4(ps + (ty + 16 * i) * kLdp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCpt];
        lds_row<kCpt>(vv, vs + (j + jj) * kLd + tx * kCpt);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float p = comp(pv[i], jj);
#pragma unroll
          for (int c = 0; c < kCpt; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    float res[kCpt];
#pragma unroll
    for (int c = 0; c < kCpt; ++c) res[c] = l[i] > 0.f ? o[i][c] / l[i] : 0.f;
    store_row<T, kCpt>(out + base + (size_t)row * D + tx * kCpt, res, 1.f);
    if (tx == 0) {
      const float lm = fmaxf(l[i], 1e-30f);
      lse[(size_t)bh * t + row] =
          use_exp2 ? (m[i] + log2f(lm)) / kLog2e : m[i] + logf(lm);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int t, int causal, int use_exp2,
               float scale, cudaStream_t stream) {
  constexpr int R = rows_f32<D>;
  constexpr size_t smem = fwd_smem_bytes<D, R>();
  unsigned blocks;
  if (int e = blocks_for(t, R, bh, &blocks)) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, D, R><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, bh, t, causal,
      use_exp2, scale);
  return (int)cudaGetLastError();
}

// flash_fwd_kernel's function at any d (multiple of 64; flash_tiles.cuh's
// d > 256 layout): out's owned 64 columns of one 64-row q tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int bh_count, int t, int d,
                      int causal, int use_exp2, float scale) {
  constexpr int R = kWideR;
  constexpr int kLd = kWideLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // slabs of Q and K
  float* ks = qs + kWideTile;
  float* vs = ks + kWideTile;  // owned columns of V
  float* ps = vs + kWideTile;

  const int parts = d / 64;
  const int nq = (t + R - 1) / R;
  const int bh = blockIdx.x % bh_count;
  const int part = (blockIdx.x / bh_count) % parts;
  const int col0 = part * 64;
  const int q0 = (nq - 1 - blockIdx.x / (bh_count * parts)) * R;  // heaviest first
  const size_t base = (size_t)bh * t * d;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float sscale = use_exp2 ? scale * kLog2e : scale;

  float m[4], l[4], o[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int k_end = causal ? min(t, q0 + R) : t;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    float s[4][4] = {};
    for (int c = 0; c < d; c += 64) {
      __syncthreads();  // the last slab (and ps, vs) is read
      load_slab<T>(qs, q + base + c, q0, t, d);
      load_slab<T>(ks, k + base + c, k0, t, d);
      if (c == 0) load_slab<T>(vs, v + base + col0, k0, t, d);
      __syncthreads();
      slab_products(s, qs, ks);
    }

    if (use_exp2)
      online_softmax<true, T, 4, 4>(s, m, l, o, ps, q0, k0, t, causal, sscale);
    else
      online_softmax<false, T, 4, 4>(s, m, l, o, ps, q0, k0, t, causal, sscale);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < R; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = lds4(ps + (ty + 16 * i) * kLd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv = lds4(vs + (j + jj) * kLd + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(pv[i], jj);
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][c] = fmaf(p, comp(vv, c), o[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    float res[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) res[c] = l[i] > 0.f ? o[i][c] / l[i] : 0.f;
    store_row<T, 4>(out + base + (size_t)row * d + col0 + tx * 4, res, 1.f);
    if (tx == 0 && part == 0) {
      const float lm = fmaxf(l[i], 1e-30f);
      lse[(size_t)bh * t + row] =
          use_exp2 ? (m[i] + log2f(lm)) / kLog2e : m[i] + logf(lm);
    }
  }
}

// K2 at d > 256: flash_wgmma's tensor-core kernel for the 16-bit types,
// the CUDA-core one above for float32.
template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* out,
                    float* lse, int bh, int t, int d, int causal,
                    int use_exp2, float scale, cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>) {
    return flash_wgmma::launch_fwd_wide<T>(q, k, v, out, lse, bh, t, d, causal,
                                           use_exp2, scale, stream);
  } else {
    constexpr size_t smem = (size_t)4 * kWideTile * sizeof(float);
    unsigned blocks;
    if (d % 64) return (int)cudaErrorInvalidValue;
    if (int e = blocks_for(t, kWideR, bh * (d / 64), &blocks)) return e;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_wide_kernel<T><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, bh, t, d, causal,
        use_exp2, scale);
    return (int)cudaGetLastError();
  }
}

// K3 (or, without kDq, K4b) at d > 256, as launch_fwd_wide.
template <typename T, bool kDq>
int bwd_wide(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, float* dq_acc, void* dk,
             void* dv, int bh, int t, int d, int causal, int use_exp2,
             float scale, cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>)
    return flash_wgmma::launch_bwd_wide<T, kDq>(q, k, v, dout, lse, delta,
                                                dq_acc, dk, dv, bh, t, d,
                                                causal, use_exp2, scale, stream);
  else
    return launch_bwd_wide<T, kDq>(q, k, v, dout, lse, delta, dq_acc, dk, dv,
                                   bh, t, d, causal, use_exp2, scale, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: [bh, t, d] contiguous, float32 (dtype = 0), bfloat16
// (dtype = 1) or float16 (dtype = 2), 16-byte aligned; lse: [bh, t]
// float32. d: 32, 64, 128, 256 or any multiple of 64 above 256 (the
// wrapper pads any other d up to one).
// scale: 1/sqrt(d) (use_exp2 folds log2(e) into it inside the kernel).
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int bh, int t, int d, int dtype, int causal,
              int use_exp2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FWD(T, D) \
  launch_fwd<T, D>(q, k, v, out, l, bh, t, causal, use_exp2, scale, s)
#define FWD_WGMMA(T, D)                                                 \
  flash_wgmma::launch_fwd<T, D>(q, k, v, out, l, bh, t, causal, use_exp2, \
                             scale, s)
#define FWD_WIDE(T) \
  launch_fwd_wide<T>(q, k, v, out, l, bh, t, d, causal, use_exp2, scale, s)
  FLASH_DISPATCH(FWD_WGMMA, FWD, FWD_WIDE);
#undef FWD_WIDE
#undef FWD_WGMMA
#undef FWD
}

// q, k, v, dout, dk, dv: [bh, t, d] as above; lse, delta: [bh, t] float32;
// dq_acc: [bh, t, d] float32, zeroed by the caller (the kernel adds into
// it).
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq_acc, void* dk,
              void* dv, int bh, int t, int d, int dtype, int causal,
              int use_exp2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dq = static_cast<float*>(dq_acc);
#define BWD(T, D)                                                          \
  launch_bwd<T, D, true>(q, k, v, dout, l, dl, dq, dk, dv, bh, t, causal,  \
                         use_exp2, scale, s)
#define BWD_WGMMA(T, D)                                                 \
  flash_wgmma::launch_bwd<T, D, true>(q, k, v, dout, l, dl, dq, dk, dv, bh, \
                                   t, causal, use_exp2, scale, s)
#define BWD_WIDE(T)                                                       \
  bwd_wide<T, true>(q, k, v, dout, l, dl, dq, dk, dv, bh, t, d, causal,   \
                    use_exp2, scale, s)
  FLASH_DISPATCH(BWD_WGMMA, BWD, BWD_WIDE);
#undef BWD_WIDE
#undef BWD_WGMMA
#undef BWD
}

// Dynamic shared memory a block of the tensor-core kernels (bf16 and fp16
// alike) takes at head dim d: kernel 0 the forward (K2), 1 the backward with dq (K3), 2
// without it (K4b), 3 the split backward's dq (K4a); at any d above 256 that
// is a multiple of 64, the d > 256 kernels'; -1 for anything else.
int flash_wgmma_smem_bytes(int kernel, int d) {
#define SMEM(D)                                                         \
  (kernel == 0   ? (int)flash_wgmma::fwd_smem_bytes<D>()                \
   : kernel == 1 ? (int)flash_wgmma::bwd_smem_bytes<D, true>()          \
   : kernel == 2 ? (int)flash_wgmma::bwd_smem_bytes<D, false>()         \
   : kernel == 3 ? (int)flash_wgmma::dq_smem_bytes<D>()                 \
                 : -1)
  if (d == 32) return SMEM(32);
  if (d == 64) return SMEM(64);
  if (d == 128) return SMEM(128);
  if (d == 256) return SMEM(256);
  if (d > 256 && d % 64 == 0)
    return kernel == 0   ? (int)flash_wgmma::fwd_wide_smem_bytes()
           : kernel == 1 ? (int)flash_wgmma::bwd_wide_smem_bytes<true>()
           : kernel == 2 ? (int)flash_wgmma::bwd_wide_smem_bytes<false>()
           : kernel == 3 ? (int)flash_wgmma::dq_wide_smem_bytes()
                         : -1;
  return -1;
#undef SMEM
}

}  // extern "C"
