// Multi-head CSR segment sum (K2) and multi-head per-edge row dots (K4).
//
// K2:  out[r, h*D + c] = sum_{e in row r} w[e, h] * x[src[e], h*D + c]
//      Replaces efficient_gnns_tpu/ops/pallas/segment_matmul.py::
//      blocked_segment_sum_heads (the TPU one-hot MXU scatter with a per-head
//      scale, over an EdgeBlocking with 128-aligned head slices) together with
//      the XLA row gather in front of it (ops/attention.py, ops/spmm.py).
// K4:  dw[e, h] = sum_c g[r_e, h*D + c] * x[src[e], h*D + c] (r_e: the row
//      that holds edge e), 0 for padding
//      Replaces segment_matmul.py::blocked_sddmm_dw_heads (the attention
//      probabilities' cotangent and the weight gradient of spmm_heads).
//
// Bound: device-memory bytes for both. K2 does 2*H*D flops per edge and K4
// 2*H*D per edge against H*D*itemsize gathered bytes, far below the card's
// flop:byte ratio. The messages (x, and g for K4) are float32 or bfloat16:
// bfloat16 halves the gathered bytes; the head weights, the products, the
// sums and the outputs are float32 either way (Pallas also rounds each
// w * x product to bfloat16, which these kernels do not).
//
// K2 design: the two passes of segment_split.cuh. One owner per output
// element and no float atomics, so the result is deterministic. A task is a
// (row, head) pair, or a (chunk, head) pair for a power-law hub row, which
// the graph's RowSplit cuts into chunks of `threshold` edges that are summed
// as independent units into partial rows; a second kernel adds them in a
// fixed order. A task is owned by a group of 8, 16 or 32 lanes (picked from
// D), the head weight uniform across the group, and each lane starts the
// loads of several edges before their multiply-adds. D is not padded to 128
// (the TPU's lanes): a lane loads 16 bytes where D is a multiple of 4 (8 in
// bfloat16), two elements where D is even (D = 250: a head starts at a
// multiple of 1,000 bytes, 500 in bfloat16), else one.
//
// K4 design: split_sddmm.cuh, on the same row walk. A (row or chunk, head)
// task loads g[r, h, :] once into a group's registers and streams the x rows
// of its edges, so g is read once per row and not once per edge; each edge's
// dot has one owner, a fixed-order butterfly: deterministic, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_split.cuh"
#include "split_sddmm.cuh"

extern "C" {

// x: [*, num_heads * d] of dtype (0 = float32, 1 = bfloat16), w: float32
// [E_pad, num_heads], src and row_offsets int32; out: float32 [num_rows,
// num_heads * d]. vec: elements per lane load (float32: 4, 2 or 1;
// bfloat16: 8, 2 or 1); the caller picks the largest that divides d with x
// aligned to vec elements. chunks [num_chunks, 3], long_rows [num_long] and
// long_first [num_long + 1] are the row split of row_offsets at `threshold`;
// partial is float32 scratch [num_chunks, num_heads * d]. Returns the first
// launch's error, else cudaGetLastError().
int egt_csr_segment_sum_heads(const void* x, const void* w, int dtype, int vec,
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
  if (dtype == 0 && vec == 4) return launch_split<float, 4>(a);
  if (dtype == 0 && vec == 2) return launch_split<float, 2>(a);
  if (dtype == 0 && vec == 1) return launch_split<float, 1>(a);
  if (dtype == 1 && vec == 8) return launch_split<__nv_bfloat16, 8>(a);
  if (dtype == 1 && vec == 2) return launch_split<__nv_bfloat16, 2>(a);
  if (dtype == 1 && vec == 1) return launch_split<__nv_bfloat16, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g: [num_rows, num_heads * d] (rows by receiver), x: [*, num_heads * d]
// (rows by sender), both of dtype (0 = float32, 1 = bfloat16); src: int32
// [E_pad] senders in CSR order, row_offsets int32 [num_rows + 1]; chunks
// [num_chunks, 3] is the row split of row_offsets at `threshold` and
// num_edges = row_offsets[num_rows]; out: float32 [E_pad, num_heads]. vec:
// elements per lane load (float32: 4, 2 or 1; bfloat16: 8, 2 or 1), the
// largest that divides d with g and x aligned to it. Returns
// cudaGetLastError().
int egt_csr_sddmm_heads(const void* g, const void* x, int dtype, int vec, const void* src,
                        const void* row_offsets, const void* chunks, void* out,
                        int num_rows, int num_chunks, int num_heads, int d,
                        int threshold, int num_edges, int num_edges_padded,
                        void* stream) {
  const SddmmArgs a{g, x,
                    static_cast<const int32_t*>(src),
                    static_cast<const int32_t*>(row_offsets),
                    static_cast<const int32_t*>(chunks),
                    static_cast<float*>(out),
                    num_rows, num_chunks, num_heads, d, threshold, num_edges,
                    num_edges_padded, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && vec == 4) return launch_split_sddmm<float, 4>(a);
  if (dtype == 0 && vec == 2) return launch_split_sddmm<float, 2>(a);
  if (dtype == 0 && vec == 1) return launch_split_sddmm<float, 1>(a);
  if (dtype == 1 && vec == 8) return launch_split_sddmm<__nv_bfloat16, 8>(a);
  if (dtype == 1 && vec == 2) return launch_split_sddmm<__nv_bfloat16, 2>(a);
  if (dtype == 1 && vec == 1) return launch_split_sddmm<__nv_bfloat16, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
