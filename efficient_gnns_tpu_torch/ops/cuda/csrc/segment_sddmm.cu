// Per-edge row dots over a receiver-sorted CSR: K3 of the port.
//
//   dw[e] = sum_c g[r_e, c] * x[src[e], c]   for e < row_offsets[num_rows]
//   dw[e] = 0                                for the padding edges past it
//
// where r_e is the row that holds edge e. Replaces
// efficient_gnns_tpu/ops/pallas/segment_matmul.py::blocked_sddmm_dw (the
// edge-weight gradient of SpMM with per-call weights: on the TPU a one-hot
// expansion of resident cotangent tiles over an EdgeBlocking with F padded
// to 128) together with the XLA gather of x[src] in front of it and the
// inverse permutation back to CSR order behind it (ops/spmm.py).
//
// Bound: device-memory bytes. An edge costs 2*F flops against F*itemsize
// gathered bytes, far below the card's flop:byte ratio.
//
// Design: split_sddmm.cuh with one head of F columns, the case H = 1 of K4.
// A row of at most `threshold` edges, or a chunk of a longer row (the
// graph's RowSplit), is one task: its group of 8, 16 or 32 lanes loads
// g[r, :] once into registers and streams the x rows of its edges, several
// loads in flight, each edge's dot a fixed-order butterfly over the group.
// The first design gave each edge its own lanes and read g[r_e] once per
// edge. Inputs are float32 or bfloat16, products and sums float32, F is not
// padded; every output has one owner, so the result is deterministic. The
// indices of padding edges are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sddmm.cuh"

extern "C" {

// g: [num_rows, f] (rows by receiver), x: [*, f] (rows by sender), both of
// dtype (0 = float32, 1 = bfloat16); src: int32 [E_pad] senders in CSR
// order; row_offsets: int32 [num_rows + 1]; chunks [num_chunks, 3] is the
// row split of row_offsets at `threshold` and num_edges =
// row_offsets[num_rows]; out: float32 [E_pad]. vec: elements per lane load
// (float32: 4, 2 or 1; bfloat16: 8, 2 or 1), the largest that divides f with g
// and x aligned to it. Returns cudaGetLastError().
int egt_csr_sddmm(const void* g, const void* x, int dtype, int vec, const void* src,
                  const void* row_offsets, const void* chunks, void* out,
                  int num_rows, int num_chunks, int f, int threshold,
                  int num_edges, int num_edges_padded, void* stream) {
  const SddmmArgs a{g, x,
                    static_cast<const int32_t*>(src),
                    static_cast<const int32_t*>(row_offsets),
                    static_cast<const int32_t*>(chunks),
                    static_cast<float*>(out),
                    num_rows, num_chunks, 1, f, threshold, num_edges,
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
