// Thin (per-head scalar) CSR segment sum and max (K5, K6) and the broadcast of
// per-row values back to the edges (K7), for edge payloads [E_pad, H], H <= 8.
//
// K5:  s[r, h] = sum_{e in row r} v[e, h]                  (0 on empty rows)
// K6:  m[r, h] = max_{e in row r} v[e, h]     (float32 lowest on empty rows)
//      Replace efficient_gnns_tpu/ops/pallas/segment_thin.py::
//      blocked_segment_sum_thin and blocked_segment_max_thin (one body,
//      _thin_call: one-hot MXU sum / masked VPU max over an EdgeBlocking).
// K7:  out[e, h] = vals[dst[e], h] for e < row_offsets[num_rows], else 0
//      Replaces segment_thin.py::tile_rows_thin (the one-hot MXU read of
//      resident destination tiles).
//
// Bound: device-memory bytes. The payloads are a few floats per edge, so
// each kernel reads or writes about 12 bytes per edge at H = 3.
//
// K5/K6 design: one template, the reduction its parameter. One warp owns an
// output row: its lanes stride the row's edges (neighbouring lanes on
// neighbouring edges, so a warp reads one contiguous run of 32*H floats), each
// lane keeps H partials in registers, and a fixed-order butterfly of
// shuffles combines the lanes. No float atomics: the sum is deterministic,
// and the max is exact. A hub row is walked by its one warp.
// K7 design: one thread per output element, the row id read from dst;
// padding edges (past row_offsets[num_rows]) are written 0 and their dst is
// never read.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxHeads = 8;
constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_reduce_thin_kernel(const float* __restrict__ v,
                               const int32_t* __restrict__ row_offsets,
                               float* __restrict__ out, int num_rows,
                               int num_heads) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // uniform across the warp
  const float init = kMax ? -FLT_MAX : 0.f;
  const int begin = row_offsets[row];
  const int end = row_offsets[row + 1];
  float acc[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) acc[h] = init;
  for (int e = begin + lane; e < end; e += 32) {
    const float* ve = v + static_cast<size_t>(e) * num_heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < num_heads) acc[h] = combine<kMax>(acc[h], __ldg(ve + h));
    }
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < num_heads) {  // uniform: every lane takes part in the shuffles
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[h] = combine<kMax>(acc[h], __shfl_xor_sync(kFullMask, acc[h], off));
      }
    }
  }
  if (lane == 0) {
    float* out_row = out + static_cast<size_t>(row) * num_heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < num_heads) out_row[h] = acc[h];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
csr_tile_rows_thin_kernel(const float* __restrict__ vals,
                          const int32_t* __restrict__ dst,
                          const int32_t* __restrict__ row_offsets,
                          float* __restrict__ out, int num_rows,
                          int64_t num_out, int num_heads) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_out) return;
  const int64_t e = i / num_heads;
  const int h = static_cast<int>(i - e * num_heads);
  float value = 0.f;
  if (e < row_offsets[num_rows]) {
    value = __ldg(vals + static_cast<int64_t>(dst[e]) * num_heads + h);
  }
  out[i] = value;
}

}  // namespace

extern "C" {

// v: float32 [E_pad, num_heads], row_offsets int32 [num_rows + 1];
// out: float32 [num_rows, num_heads]. op: 0 = sum, 1 = max. num_heads <= 8.
// Returns cudaGetLastError().
int egt_csr_segment_reduce_thin(const void* v, const void* row_offsets,
                                void* out, int num_rows, int num_heads, int op,
                                void* stream) {
  if (num_heads < 1 || num_heads > kMaxHeads || (op != 0 && op != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows > 0) {
    const dim3 block(kWarpsPerBlock * 32);
    const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const float* vf = static_cast<const float*>(v);
    const int32_t* ro = static_cast<const int32_t*>(row_offsets);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (op == 1) {
      csr_segment_reduce_thin_kernel<true><<<grid, block, 0, st>>>(
          vf, ro, o, num_rows, num_heads);
    } else {
      csr_segment_reduce_thin_kernel<false><<<grid, block, 0, st>>>(
          vf, ro, o, num_rows, num_heads);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// vals: float32 [num_rows, num_heads], dst int32 [E_pad] (receivers in CSR
// order), row_offsets int32 [num_rows + 1]; out: float32 [E_pad, num_heads].
// Returns cudaGetLastError().
int egt_csr_tile_rows_thin(const void* vals, const void* dst,
                           const void* row_offsets, void* out, int num_rows,
                           int num_edges_padded, int num_heads, void* stream) {
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t num_out = static_cast<int64_t>(num_edges_padded) * num_heads;
  if (num_out > 0) {
    const dim3 grid(static_cast<unsigned>((num_out + kThreads - 1) / kThreads));
    csr_tile_rows_thin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(dst),
        static_cast<const int32_t*>(row_offsets), static_cast<float*>(out),
        num_rows, num_out, num_heads);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
