// Per-edge row dots over a receiver-sorted CSR: K3 of the port.
//
//   dw[e] = sum_c g[dst[e], c] * x[src[e], c]   for e < row_offsets[num_rows]
//   dw[e] = 0                                   for the padding edges past it
//
// Replaces efficient_gnns_tpu/ops/pallas/segment_matmul.py::blocked_sddmm_dw
// (the edge-weight gradient of SpMM with per-call weights: on the TPU a
// one-hot expansion of resident cotangent tiles over an EdgeBlocking with F
// padded to 128) together with the XLA gather of x[src] in front of it and
// the inverse permutation back to CSR order behind it (ops/spmm.py).
//
// Bound: device-memory bytes. An edge costs 2*F flops against 2*F*itemsize
// gathered bytes, far below the card's flop:byte ratio.
//
// Design: every output belongs to one edge, so edges are owned, not rows:
// no hub imbalance, no atomics. A group of G lanes (8, 16 or 32) owns one
// edge, so a warp takes 32/G edges: at F = 256 a full warp reads the two
// rows with two 16-byte loads per lane and row, at F = 40 two edges share a
// warp. The lanes of a group stride the columns in vectors of V elements
// (one 16-byte load where F and the base address allow, else V = 1), and the
// group's sum is a fixed-order butterfly of shuffles: deterministic. Inputs
// are float32 or bfloat16, products and sums float32, F is not padded. The
// indices of padding edges are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_load.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, int V, int G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sddmm_kernel(const T* __restrict__ g, const T* __restrict__ x,
                 const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ row_offsets, float* __restrict__ out,
                 int num_rows, int num_edges_padded, int f) {
  constexpr int kEdgesPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t first = warp * kEdgesPerWarp;
  if (first >= num_edges_padded) return;  // uniform across the warp
  // every lane stays for the shuffles; a group past the end only adds zeros
  const int64_t e = first + lane / G;
  const bool in_range = e < num_edges_padded;
  float acc = 0.f;
  if (in_range && e < row_offsets[num_rows]) {
    const T* gr = g + static_cast<size_t>(dst[e]) * f;
    const T* xs = x + static_cast<size_t>(src[e]) * f;
#pragma unroll 2
    for (int c = sub * V; c < f; c += G * V) {
      float a[V], b[V];
      Loader<T, V>::load(gr + c, a);
      Loader<T, V>::load(xs + c, b);
#pragma unroll
      for (int k = 0; k < V; ++k) acc = fmaf(a[k], b[k], acc);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFullMask, acc, off);
  }
  if (in_range && sub == 0) out[e] = acc;
}

template <typename T, int V, int G>
void launch_group(const void* g, const void* x, const int32_t* src,
                  const int32_t* dst, const int32_t* row_offsets, float* out,
                  int num_rows, int num_edges_padded, int f, cudaStream_t stream) {
  constexpr int kEdgesPerBlock = kWarpsPerBlock * (32 / G);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((num_edges_padded + kEdgesPerBlock - 1) / kEdgesPerBlock);
  csr_sddmm_kernel<T, V, G><<<grid, block, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), src, dst, row_offsets,
      out, num_rows, num_edges_padded, f);
}

template <typename T, int V>
bool launch(int group, const void* g, const void* x, const int32_t* src,
            const int32_t* dst, const int32_t* row_offsets, float* out,
            int num_rows, int num_edges_padded, int f, cudaStream_t stream) {
  if (group == 8) {
    launch_group<T, V, 8>(g, x, src, dst, row_offsets, out, num_rows,
                          num_edges_padded, f, stream);
  } else if (group == 16) {
    launch_group<T, V, 16>(g, x, src, dst, row_offsets, out, num_rows,
                           num_edges_padded, f, stream);
  } else if (group == 32) {
    launch_group<T, V, 32>(g, x, src, dst, row_offsets, out, num_rows,
                           num_edges_padded, f, stream);
  } else {
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// g: [num_rows, f] (rows by receiver), x: [*, f] (rows by sender), both of
// dtype (0 = float32, 1 = bfloat16); src / dst: int32 [E_pad] edge endpoints
// in CSR order; row_offsets: int32 [num_rows + 1]; out: float32 [E_pad].
// vec: elements per lane load (float32: 4 or 1; bfloat16: 8 or 1); the
// caller picks 1 unless f % vec == 0 and g and x are 16-byte aligned.
// group: lanes per edge (8, 16 or 32). Returns cudaGetLastError().
int egt_csr_sddmm(const void* g, const void* x, int dtype, int vec, int group,
                  const void* src, const void* dst, const void* row_offsets,
                  void* out, int num_rows, int num_edges_padded, int f,
                  void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges_padded > 0) {
    const int32_t* s = static_cast<const int32_t*>(src);
    const int32_t* d = static_cast<const int32_t*>(dst);
    const int32_t* ro = static_cast<const int32_t*>(row_offsets);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bool ok = false;
    if (dtype == 0 && vec == 4) {
      ok = launch<float, 4>(group, g, x, s, d, ro, o, num_rows, num_edges_padded, f, st);
    } else if (dtype == 0 && vec == 1) {
      ok = launch<float, 1>(group, g, x, s, d, ro, o, num_rows, num_edges_padded, f, st);
    } else if (dtype == 1 && vec == 8) {
      ok = launch<__nv_bfloat16, 8>(group, g, x, s, d, ro, o, num_rows, num_edges_padded, f, st);
    } else if (dtype == 1 && vec == 1) {
      ok = launch<__nv_bfloat16, 1>(group, g, x, s, d, ro, o, num_rows, num_edges_padded, f, st);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
