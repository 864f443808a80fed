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
// Design: the two passes of segment_split.cuh with one head of F columns.
// One owner per output element and no float atomics, so the result is
// deterministic. Rows of at most `threshold` edges are summed by one group
// of 8, 16 or 32 lanes (picked from F, so that a warp carries up to four
// short rows); a power-law hub row is cut into chunks of `threshold` edges
// (the graph's RowSplit) that are summed as independent units into partial
// rows, which a second kernel adds in a fixed order. Each lane starts the
// loads of several edges before their multiply-adds. x is float32 or
// bfloat16, w float32 or null (unweighted); products, sums and the output
// are float32. Padding edges lie past row_offsets[num_rows] and are never
// read.

#include "segment_split.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: elements per lane load (float32:
// 4, 2 or 1; bfloat16: 8, 2 or 1); the caller picks the largest that divides f
// with x aligned to vec elements. w may be null (unweighted). chunks
// [num_chunks, 3], long_rows [num_long] and long_first [num_long + 1] are
// the row split of row_offsets at `threshold`; partial is float32 scratch
// [num_chunks, f]. Returns the first launch's error, else cudaGetLastError().
int egt_csr_segment_sum(const void* x, int dtype, int vec, const void* src,
                        const void* w, const void* row_offsets,
                        const void* chunks, const void* long_rows,
                        const void* long_first, void* out, void* partial,
                        int num_rows, int num_chunks, int num_long, int f,
                        int threshold, void* stream) {
  const SplitArgs a{x,
                    static_cast<const int32_t*>(src),
                    static_cast<const float*>(w),
                    static_cast<const int32_t*>(row_offsets),
                    static_cast<const int32_t*>(chunks),
                    static_cast<const int32_t*>(long_rows),
                    static_cast<const int32_t*>(long_first),
                    static_cast<float*>(out),
                    static_cast<float*>(partial),
                    num_rows, num_chunks, num_long, 1, f, threshold,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && vec == 4) return launch_split<float, 4>(a);
  if (dtype == 0 && vec == 2) return launch_split<float, 2>(a);
  if (dtype == 0 && vec == 1) return launch_split<float, 1>(a);
  if (dtype == 1 && vec == 8) return launch_split<__nv_bfloat16, 8>(a);
  if (dtype == 1 && vec == 2) return launch_split<__nv_bfloat16, 2>(a);
  if (dtype == 1 && vec == 1) return launch_split<__nv_bfloat16, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
