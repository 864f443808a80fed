// CSR segment sum with the row gather fused in: K1 of the port.
//
//   out[r, :] = sum_{e in row_offsets[r] .. row_offsets[r+1]} w[e] * x[src[e], :]
//
// Replaces efficient_gnns_tpu/ops/pallas/segment_matmul.py::blocked_segment_sum
// (the TPU one-hot MXU scatter over an EdgeBlocking) together with the
// separate XLA row gather in front of it (ops/spmm.py::_blocked_scatter).
//
// Bound: device-memory bytes. Each edge costs 2*F flops against F*itemsize
// gathered bytes, far below the card's flop:byte ratio.
//
// Design: one owner per output row and no float atomics, so the result is
// deterministic (summation in edge order). One warp owns one row; its lanes
// split the feature columns (V contiguous elements each, one 16-byte load
// where alignment allows) and walk the row's edges. The warp loads 32 edge
// indices and weights at once, one per lane, and broadcasts them with
// shuffles. Accumulation is float32 for float32 or bfloat16 inputs, and the
// output is float32. Padding edges lie past row_offsets[num_rows] and are
// never read. A row with many edges is walked by its one warp alone, so
// power-law hub rows serialize; splitting them is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_load.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, int V, bool kWeighted>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_sum_kernel(const T* __restrict__ x, const int32_t* __restrict__ src,
                       const float* __restrict__ w,
                       const int32_t* __restrict__ row_offsets,
                       float* __restrict__ out, int num_rows, int f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // uniform across the warp
  const int begin = row_offsets[row];
  const int end = row_offsets[row + 1];
  float* out_row = out + static_cast<size_t>(row) * f;

  // every lane runs every pass so the shuffles see the full warp
  for (int pass = 0; pass < f; pass += 32 * V) {
    const int col = pass + lane * V;
    const bool active = col < f;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;

    for (int base = begin; base < end; base += 32) {
      const int e = base + lane;
      int s = 0;
      float we = 0.f;
      if (e < end) {
        s = src[e];
        we = kWeighted ? w[e] : 1.f;
      }
      const int n = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int sj = __shfl_sync(kFullMask, s, j);
        const float wj = __shfl_sync(kFullMask, we, j);
        if (active) {
          float v[V];
          Loader<T, V>::load(x + static_cast<size_t>(sj) * f + col, v);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(wj, v[k], acc[k]);
        }
      }
    }

    if (active) {
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int k = 0; k < V; k += 4) {
          *reinterpret_cast<float4*>(out_row + col + k) =
              make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) out_row[col + k] = acc[k];
      }
    }
  }
}

template <typename T, int V>
void launch(const void* x, const int32_t* src, const float* w,
            const int32_t* row_offsets, float* out, int num_rows, int f,
            cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  if (w != nullptr) {
    csr_segment_sum_kernel<T, V, true>
        <<<grid, block, 0, stream>>>(xt, src, w, row_offsets, out, num_rows, f);
  } else {
    csr_segment_sum_kernel<T, V, false>
        <<<grid, block, 0, stream>>>(xt, src, w, row_offsets, out, num_rows, f);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: elements per lane load (float32:
// 4 or 1; bfloat16: 8 or 1); the caller picks 1 unless f % vec == 0 and x is
// 16-byte aligned. w may be null (unweighted). Returns cudaGetLastError().
int egt_csr_segment_sum(const void* x, int dtype, int vec, const void* src,
                        const void* w, const void* row_offsets, void* out,
                        int num_rows, int f, void* stream) {
  if (num_rows > 0 && f > 0) {
    const int32_t* s = static_cast<const int32_t*>(src);
    const float* wf = static_cast<const float*>(w);
    const int32_t* ro = static_cast<const int32_t*>(row_offsets);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && vec == 4) {
      launch<float, 4>(x, s, wf, ro, o, num_rows, f, st);
    } else if (dtype == 0 && vec == 1) {
      launch<float, 1>(x, s, wf, ro, o, num_rows, f, st);
    } else if (dtype == 1 && vec == 8) {
      launch<__nv_bfloat16, 8>(x, s, wf, ro, o, num_rows, f, st);
    } else if (dtype == 1 && vec == 1) {
      launch<__nv_bfloat16, 1>(x, s, wf, ro, o, num_rows, f, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
