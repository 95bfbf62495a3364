// Helpers shared by the float32 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): 16-byte element loads
// and stores, staging of a tile into float32 shared memory, and float4
// arithmetic on the CUDA cores; and the finite mask value of all of them.
// The bf16 kernels take their building blocks from hopper_tc.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define MASK_VALUE (-1e30f)

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int CH = 4;  // elements in 16 bytes
  __device__ static void load(const float* p, float* d) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  __device__ static void store4(float* p, float a, float b, float c, float e) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
  }
};

// rows x D elements from `src` (row stride `stride`) into float32 shared
// memory with leading dimension `ld`, times `mul`; rows >= `valid` are 0.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t stride, int rows, int valid,
                                      float mul) {
  constexpr int CH = Elem<T>::CH;
  constexpr int CPR = D / CH;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * CH;
    float x[CH];
    if (r < valid) {
      Elem<T>::load(src + r * stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) x[e] = 0.f;
    }
    float* d = dst + r * ld + c;
#pragma unroll
    for (int e = 0; e < CH; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(x[e] * mul, x[e + 1] * mul, x[e + 2] * mul,
                      x[e + 3] * mul);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
