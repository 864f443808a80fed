// Loads of V contiguous elements of a feature row into float registers,
// shared by the kernels that gather rows (K1 and K2 through
// segment_split.cuh, K3 and K4 through split_sddmm.cuh). V > 1 is one load
// of V elements (16 bytes; 8 for two floats, 4 for two bfloat16) and needs
// an address aligned to its size (the wrappers pick a smaller V otherwise).
// The two-element bfloat16 load serves heads whose D is even but no multiple
// of 8 (the GAT teacher's D = 250: a head starts at a 500-byte offset).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int V>
struct Loader;

template <>
struct Loader<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct Loader<float, 2> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  }
};

template <>
struct Loader<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Loader<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const float2 f = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = f.x;
    v[1] = f.y;
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

}  // namespace
