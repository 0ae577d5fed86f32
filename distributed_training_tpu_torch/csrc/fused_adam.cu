// Fused Adam for Hopper (sm_90a): one multi-tensor pass over p, g, m, v.
//
// Replaces the Pallas kernel distributed_training_tpu/ops/fused_adam.py
// (fused_adam_kernel_update, kernel body _make_kernel). Same function, in
// float32, operation for operation:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*(m'*bc1) / (sqrt(v'*bc2) + eps)
// with bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t) computed by the caller. Every
// operation rounds on its own (__fmul_rn and friends keep nvcc from
// contracting pairs into FMAs), so the result is the plain PyTorch
// version's (ops/fused_adam.py::fused_adam_reference) bit for bit.
//
// What bounds it: bytes. Per element it reads p, g, m, v and writes p, m, v:
// 28 bytes for ~12 flops, far below the ~20 flop/byte the card needs before
// arithmetic would matter. So the design only tries to keep HBM busy:
//   - one launch for up to kMaxTensors tensors (ResNet-18's 62 in one), the
//     tensor table passed by value as the kernel's parameter block (CUDA
//     12.1+ allows 32 KB of parameters), so nothing is staged in device
//     memory and no copy precedes the launch;
//   - each block takes one chunk of kChunk elements of one tensor (a binary
//     search over the chunk prefix finds which), so big and small tensors
//     share one grid with no padding copies (the TPU's (rows, 128) tiles
//     were a layout of that machine, not of this one);
//   - 16-byte float4 loads and stores where all seven pointers are
//     16-byte aligned, scalar otherwise and for the ragged tail.
// Inputs and outputs are separate pointers that may alias: the caller
// updates in place, or writes a candidate out of place when a dynamic
// loss scale may still reject the step.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launches; the launch is asynchronous on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 128;
constexpr int kChunk = 16384;  // elements per block
constexpr int kThreads = 256;

struct TensorTable {
  const float* p_in[kMaxTensors];
  const float* g[kMaxTensors];
  const float* m_in[kMaxTensors];
  const float* v_in[kMaxTensors];
  float* p_out[kMaxTensors];
  float* m_out[kMaxTensors];
  float* v_out[kMaxTensors];
  int64_t numel[kMaxTensors];
  int chunk_start[kMaxTensors + 1];
  int n;
};

struct Scalars {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_elem(float p, float g, float m, float v,
                                          const Scalars& s, float& p_new,
                                          float& m_new, float& v_new) {
  m_new = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v_new = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float num = __fmul_rn(s.lr, __fmul_rn(m_new, s.bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v_new, s.bc2)), s.eps);
  p_new = __fsub_rn(p, __fdiv_rn(num, den));
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const __grid_constant__ TensorTable t,
                  const __grid_constant__ Scalars s) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.n;  // largest lo with chunk_start[lo] <= b
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_start[mid] <= b) lo = mid; else hi = mid;
  }
  const int k = lo;
  const int64_t start = (int64_t)(b - t.chunk_start[k]) * kChunk;
  const int64_t end = min(start + (int64_t)kChunk, t.numel[k]);
  const float* p_in = t.p_in[k];
  const float* g = t.g[k];
  const float* m_in = t.m_in[k];
  const float* v_in = t.v_in[k];
  float* p_out = t.p_out[k];
  float* m_out = t.m_out[k];
  float* v_out = t.v_out[k];

  const uintptr_t any = (uintptr_t)p_in | (uintptr_t)g | (uintptr_t)m_in |
                        (uintptr_t)v_in | (uintptr_t)p_out |
                        (uintptr_t)m_out | (uintptr_t)v_out;
  int64_t i = start;
  if ((any & 15) == 0) {
    const int64_t vec_end = start + ((end - start) & ~(int64_t)3);
    for (int64_t j = start + 4 * (int64_t)threadIdx.x; j < vec_end;
         j += 4 * kThreads) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_in + j);
      const float4 g4 = *reinterpret_cast<const float4*>(g + j);
      const float4 m4 = *reinterpret_cast<const float4*>(m_in + j);
      const float4 v4 = *reinterpret_cast<const float4*>(v_in + j);
      float4 po, mo, vo;
      adam_elem(p4.x, g4.x, m4.x, v4.x, s, po.x, mo.x, vo.x);
      adam_elem(p4.y, g4.y, m4.y, v4.y, s, po.y, mo.y, vo.y);
      adam_elem(p4.z, g4.z, m4.z, v4.z, s, po.z, mo.z, vo.z);
      adam_elem(p4.w, g4.w, m4.w, v4.w, s, po.w, mo.w, vo.w);
      *reinterpret_cast<float4*>(p_out + j) = po;
      *reinterpret_cast<float4*>(m_out + j) = mo;
      *reinterpret_cast<float4*>(v_out + j) = vo;
    }
    i = vec_end;
  }
  for (int64_t j = i + threadIdx.x; j < end; j += kThreads) {
    float po, mo, vo;
    adam_elem(p_in[j], g[j], m_in[j], v_in[j], s, po, mo, vo);
    p_out[j] = po;
    m_out[j] = mo;
    v_out[j] = vo;
  }
}

}  // namespace

extern "C" {

int fused_adam_max_tensors() { return kMaxTensors; }

// ptrs: 7 pointers per tensor, in the order p_in, g, m_in, v_in, p_out,
// m_out, v_out. numels: elements per tensor. One launch per kMaxTensors
// tensors.
int fused_adam_multi(const void* const* ptrs, const int64_t* numels,
                     int n_tensors, float lr, float bc1, float bc2, float b1,
                     float omb1, float b2, float omb2, float eps,
                     void* stream) {
  const Scalars s{lr, bc1, bc2, b1, omb1, b2, omb2, eps};
  for (int base = 0; base < n_tensors; base += kMaxTensors) {
    TensorTable t;
    const int n = n_tensors - base < kMaxTensors ? n_tensors - base
                                                 : kMaxTensors;
    int64_t chunks = 0;
    for (int i = 0; i < n; ++i) {
      const void* const* q = ptrs + 7 * (base + i);
      t.p_in[i] = static_cast<const float*>(q[0]);
      t.g[i] = static_cast<const float*>(q[1]);
      t.m_in[i] = static_cast<const float*>(q[2]);
      t.v_in[i] = static_cast<const float*>(q[3]);
      t.p_out[i] = static_cast<float*>(const_cast<void*>(q[4]));
      t.m_out[i] = static_cast<float*>(const_cast<void*>(q[5]));
      t.v_out[i] = static_cast<float*>(const_cast<void*>(q[6]));
      t.numel[i] = numels[base + i];
      t.chunk_start[i] = static_cast<int>(chunks);
      chunks += (numels[base + i] + kChunk - 1) / kChunk;
    }
    if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    t.chunk_start[n] = static_cast<int>(chunks);
    t.n = n;
    if (chunks == 0) continue;
    fused_adam_kernel<<<static_cast<unsigned>(chunks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
