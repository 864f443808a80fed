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
// K2 design: K1's, one owner per output slice: a warp owns one (row, head)
// pair, so there are no float atomics and the result is deterministic
// (summation in edge order), and a row's heads run on H warps side by side.
// The warp loads 32 edge indices and their head weights at once, one edge per
// lane, and broadcasts them with shuffles; the weight is uniform across the
// warp, and each lane keeps the float32 sums of KD columns (lane, lane+32,
// ...) of the head in registers, issuing the KD loads of an edge before its
// KD multiply-adds. D is not padded to 128 (the TPU's lanes) and need not be
// a multiple of 4: loads are 4-byte, neighbouring lanes on neighbouring
// columns. Hub rows serialize on their warps, as in K1.
//
// K4 design: one warp per edge. Every output belongs to one edge, so edge
// ownership has no hub imbalance (row ownership would keep g[r] in registers
// but walk a hub row's edges on one warp). The lanes stride the head's D
// columns of g[dst[e]] and x[src[e]] and the head's sum is a fixed-order
// butterfly of shuffles: deterministic. Edges past row_offsets[num_rows]
// (padding) get 0 and read nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <int KD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_sum_heads_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const int32_t* __restrict__ src,
                             const int32_t* __restrict__ row_offsets,
                             float* __restrict__ out, int num_rows,
                             int num_heads, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (task >= static_cast<int64_t>(num_rows) * num_heads) return;  // uniform across the warp
  const int row = static_cast<int>(task / num_heads);
  const int h = static_cast<int>(task - static_cast<int64_t>(row) * num_heads);
  const size_t hd = static_cast<size_t>(num_heads) * d;
  const int begin = row_offsets[row];
  const int end = row_offsets[row + 1];
  const float* x_h = x + static_cast<size_t>(h) * d + lane;
  float* out_h = out + row * hd + static_cast<size_t>(h) * d + lane;

  // every lane runs every pass so the shuffles see the full warp
  for (int pass = 0; pass < d; pass += 32 * KD) {
    float acc[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) acc[k] = 0.f;

    for (int base = begin; base < end; base += 32) {
      const int e = base + lane;
      int s = 0;
      float we = 0.f;
      if (e < end) {
        s = src[e];
        we = w[static_cast<size_t>(e) * num_heads + h];
      }
      const int n = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int sj = __shfl_sync(kFullMask, s, j);
        const float wj = __shfl_sync(kFullMask, we, j);
        const float* xr = x_h + sj * hd + pass;
        float v[KD];  // all loads first: KD rows segments in flight at once
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          v[k] = pass + lane + 32 * k < d ? __ldg(xr + 32 * k) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < KD; ++k) acc[k] = fmaf(wj, v[k], acc[k]);
      }
    }

#pragma unroll
    for (int k = 0; k < KD; ++k) {
      if (pass + lane + 32 * k < d) out_h[pass + 32 * k] = acc[k];
    }
  }
}

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

template <int KD>
void launch_heads(const float* x, const float* w, const int32_t* src,
                  const int32_t* row_offsets, float* out, int num_rows,
                  int num_heads, int d, cudaStream_t stream) {
  const int64_t tasks = static_cast<int64_t>(num_rows) * num_heads;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock));
  csr_segment_sum_heads_kernel<KD><<<grid, block, 0, stream>>>(
      x, w, src, row_offsets, out, num_rows, num_heads, d);
}

}  // namespace

extern "C" {

// x: float32 [*, num_heads * d], w: float32 [E_pad, num_heads], src and
// row_offsets int32; out: float32 [num_rows, num_heads * d].
// Returns cudaGetLastError().
int egt_csr_segment_sum_heads(const void* x, const void* w, const void* src,
                              const void* row_offsets, void* out, int num_rows,
                              int num_heads, int d, void* stream) {
  if (num_heads < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows > 0) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const int32_t* s = static_cast<const int32_t*>(src);
    const int32_t* ro = static_cast<const int32_t*>(row_offsets);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the fewest columns per lane that cover a head in one pass; wider heads
    // take several passes of 256 columns
    if (d <= 32) {
      launch_heads<1>(xf, wf, s, ro, o, num_rows, num_heads, d, st);
    } else if (d <= 64) {
      launch_heads<2>(xf, wf, s, ro, o, num_rows, num_heads, d, st);
    } else if (d <= 128) {
      launch_heads<4>(xf, wf, s, ro, o, num_rows, num_heads, d, st);
    } else {
      launch_heads<8>(xf, wf, s, ro, o, num_rows, num_heads, d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
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
