// Multi-head CSR segment sum (K2) and multi-head per-edge row dots (K4).
//
// K2:  out[r, h*D + c] = sum_{e in row r} w[e, h] * x[src[e], h*D + c]
//      Replaces efficient_gnns_tpu/ops/pallas/segment_matmul.py::
//      blocked_segment_sum_heads (the TPU one-hot MXU scatter with a per-head
//      scale, over an EdgeBlocking with 128-aligned head slices) together with
//      the XLA row gather in front of it (ops/attention.py, ops/spmm.py).
// K4:  dw[e, h] = sum_c g[dst[e], h*D + c] * x[src[e], h*D + c], 0 for padding
//      Replaces segment_matmul.py::blocked_sddmm_dw_heads (the attention
//      probabilities' cotangent and the weight gradient of spmm_heads).
//
// Bound: device-memory bytes for both. K2 does 2*H*D flops per edge and K4
// 2*H*D per edge against H*D*4 gathered bytes, far below the card's
// flop:byte ratio.
//
// K2 design: the two passes of segment_split.cuh. One owner per output
// element and no float atomics, so the result is deterministic. A task is a
// (row, head) pair, or a (chunk, head) pair for a power-law hub row, which
// the graph's RowSplit cuts into chunks of `threshold` edges that are summed
// as independent units into partial rows; a second kernel adds them in a
// fixed order. A task is owned by a group of 8, 16 or 32 lanes (picked from
// D), the head weight uniform across the group, and each lane starts the
// loads of several edges before their multiply-adds. D is not padded to 128
// (the TPU's lanes): a lane loads 16 bytes where D is a multiple of 4, 8
// bytes where it is even (D = 250: a head starts at a multiple of 1,000
// bytes), else 4.
//
// K4 design: one warp per edge. Every output belongs to one edge, so edge
// ownership has no hub imbalance (row ownership would keep g[r] in registers
// but walk a hub row's edges on one warp). The lanes stride the head's D
// columns of g[dst[e]] and x[src[e]] and the head's sum is a fixed-order
// butterfly of shuffles: deterministic. Edges past row_offsets[num_rows]
// (padding) get 0 and read nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_split.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sddmm_heads_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const int32_t* __restrict__ src,
                       const int32_t* __restrict__ dst,
                       const int32_t* __restrict__ row_offsets,
                       float* __restrict__ out, int num_rows,
                       int num_edges_padded, int num_heads, int d) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= num_edges_padded) return;  // uniform across the warp
  float* out_e = out + static_cast<size_t>(e) * num_heads;
  if (e >= row_offsets[num_rows]) {  // padding edge: never read its indices
    for (int h = lane; h < num_heads; h += 32) out_e[h] = 0.f;
    return;
  }
  const size_t hd = static_cast<size_t>(num_heads) * d;
  const float* gr = g + static_cast<size_t>(dst[e]) * hd;
  const float* xs = x + static_cast<size_t>(src[e]) * hd;
  for (int h = 0; h < num_heads; ++h) {
    float acc = 0.f;
    for (int c = h * d + lane; c < (h + 1) * d; c += 32) {
      acc = fmaf(__ldg(gr + c), __ldg(xs + c), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFullMask, acc, off);
    }
    if (lane == 0) out_e[h] = acc;
  }
}

}  // namespace

extern "C" {

// x: float32 [*, num_heads * d], w: float32 [E_pad, num_heads], src and
// row_offsets int32; out: float32 [num_rows, num_heads * d]. vec: floats per
// lane load (4, 2 or 1); the caller picks the largest that divides d with x
// aligned to vec floats. chunks [num_chunks, 3], long_rows [num_long] and
// long_first [num_long + 1] are the row split of row_offsets at `threshold`;
// partial is float32 scratch [num_chunks, num_heads * d]. Returns the first
// launch's error, else cudaGetLastError().
int egt_csr_segment_sum_heads(const void* x, const void* w, int vec,
                              const void* src, const void* row_offsets,
                              const void* chunks, const void* long_rows,
                              const void* long_first, void* out, void* partial,
                              int num_rows, int num_chunks, int num_long,
                              int num_heads, int d, int threshold, void* stream) {
  if (num_heads < 1 || d < 1 || w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{x,
                    static_cast<const int32_t*>(src),
                    static_cast<const float*>(w),
                    static_cast<const int32_t*>(row_offsets),
                    static_cast<const int32_t*>(chunks),
                    static_cast<const int32_t*>(long_rows),
                    static_cast<const int32_t*>(long_first),
                    static_cast<float*>(out),
                    static_cast<float*>(partial),
                    num_rows, num_chunks, num_long, num_heads, d, threshold,
                    static_cast<cudaStream_t>(stream)};
  if (vec == 4) return launch_split<float, 4>(a);
  if (vec == 2) return launch_split<float, 2>(a);
  if (vec == 1) return launch_split<float, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g: float32 [num_rows, num_heads * d] (rows by receiver), x: float32
// [*, num_heads * d] (rows by sender), src / dst: int32 [E_pad] edge
// endpoints in CSR order, row_offsets int32 [num_rows + 1]; out: float32
// [E_pad, num_heads]. Returns cudaGetLastError().
int egt_csr_sddmm_heads(const void* g, const void* x, const void* src,
                        const void* dst, const void* row_offsets, void* out,
                        int num_rows, int num_edges_padded, int num_heads,
                        int d, void* stream) {
  if (num_heads < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges_padded > 0) {
    const dim3 block(kWarpsPerBlock * 32);
    const dim3 grid((num_edges_padded + kWarpsPerBlock - 1) / kWarpsPerBlock);
    csr_sddmm_heads_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
        static_cast<const int32_t*>(row_offsets), static_cast<float*>(out),
        num_rows, num_edges_padded, num_heads, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
