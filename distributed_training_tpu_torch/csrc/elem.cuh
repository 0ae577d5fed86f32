// Loads and stores of four consecutive elements as float32, and the
// rounding of a float32 to the element type, for the CUDA-core kernels'
// element type: float32. Every bfloat16 kernel runs on the tensor cores
// (wgmma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};
