// The CSR segment sum with a fused row gather and a deterministic split of
// the long rows: the two passes that K1 (segment_sum.cu) and K2
// (segment_heads.cu) share.
//
//   out[r, h*D + c] = sum_{e in row r} w[e, h] * x[src[e], h*D + c]
//
// (K1 is the case of one head, with w optional.)
//
// Bound: device-memory bytes. An edge costs 2*H*D flops against H*D*itemsize
// gathered bytes, far below the card's flop:byte ratio, so the tensor cores
// have nothing to offer and the design is about keeping many independent
// gathers in flight on every SM.
//
// Ownership. Every output element has one owner and there are no float
// atomics, so the same input gives the same bits at every launch. A unit of
// work is a whole row of at most `threshold` edges, or one chunk of at most
// `threshold` consecutive edges of a longer row (the schedule of
// graphs/row_split.py, built once per graph on the host). A power-law hub row
// of 151k edges is thus 1,180 independent units instead of one serial walk.
// Pass 1 sums every unit: a short row straight into `out`, a chunk into its
// slot of `partial`. Pass 2 sums each long row's slots in a fixed order into
// `out`. The chunks come first in the grid, so the heavy units start first
// and the short rows fill the tail.
//
// Lanes. A task is a (unit, head) pair, owned by a group of G lanes (8, 16
// or 32, the fewest that cover the head's D columns in vectors of V
// elements), so a warp carries 32/G tasks: 2 at D = 40 in float32, 4 in
// bfloat16. The head weight is uniform across the group. A lane keeps KV
// vectors of float32 sums (columns (k*G + lane)*V) in registers; heads wider
// than G*KV*V columns take several passes over the edges.
//
// Latency. A lane reads the indices and weights of U edges, then starts all
// their row loads (U*KV loads of V elements, 16 bytes where the alignment
// allows), then does the multiply-adds. Measured on the H100 at ogbn-arxiv
// shape, resident warps hide the gather latency better than loads per lane:
// about 16 gathered floats in flight per lane (U = 2 at F = 256 in float32)
// under a cap of 48 registers, which keeps 40 warps on an SM, beat 64 floats
// in flight at 126 registers and 16 warps at every shape (PERF.md). The
// lanes of a group read the same index and weight address, which the load
// unit serves as one broadcast.
//
// Padding edges lie past row_offsets[num_rows] and are never read; empty
// rows are written as zeros; D need not be a multiple of V = 4 (the wrappers
// pick V from D and the base address).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_load.cuh"

namespace {

constexpr int kSplitWarps = 4;    // warps per block in pass 1
constexpr int kReduceWarps = 16;  // warps per block in pass 2

// Edges whose row loads a lane starts before their multiply-adds: about 16
// gathered floats in flight per lane, at most 8 edges.
__host__ __device__ constexpr int edges_in_flight(int v, int kv) {
  return 16 / (v * kv) > 8 ? 8 : (16 / (v * kv) < 1 ? 1 : 16 / (v * kv));
}

// Blocks of pass 1 that must fit one SM: 10 (40 warps, at most 48 registers
// a thread) where a lane holds at most 8 sums, 6 for the wider heads.
__host__ __device__ constexpr int min_blocks(int v, int kv) { return v * kv > 8 ? 6 : 10; }

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// Pass 1. chunks: int32 [num_chunks, 3] (row, begin, end). w: [*, num_heads]
// or null (weight 1). x: [*, num_heads * d]; out: [num_rows, num_heads * d];
// partial: [num_chunks, num_heads * d].
template <typename T, int V, int G, int KV>
__global__ void __launch_bounds__(kSplitWarps * 32, min_blocks(V, KV))
split_segment_sum_kernel(const T* __restrict__ x, const int32_t* __restrict__ src,
                         const float* __restrict__ w,
                         const int32_t* __restrict__ row_offsets,
                         const int32_t* __restrict__ chunks,
                         float* __restrict__ out, float* __restrict__ partial,
                         int num_rows, int num_chunks, int num_heads, int d,
                         int threshold) {
  constexpr int U = edges_in_flight(V, KV);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kSplitWarps + (threadIdx.x >> 5);
  const int64_t task = warp * (32 / G) + lane / G;
  const int64_t num_units = static_cast<int64_t>(num_chunks) + num_rows;
  // no warp-wide operation below: a group may leave on its own
  if (task >= num_units * num_heads) return;
  const int unit = static_cast<int>(task / num_heads);
  const int h = static_cast<int>(task - static_cast<int64_t>(unit) * num_heads);
  const size_t hd = static_cast<size_t>(num_heads) * d;
  int begin, end;
  float* dst;
  if (unit < num_chunks) {
    begin = chunks[3 * unit + 1];
    end = chunks[3 * unit + 2];
    dst = partial + unit * hd;
  } else {
    const int row = unit - num_chunks;
    begin = row_offsets[row];
    end = row_offsets[row + 1];
    if (end - begin > threshold) return;  // a long row: its chunks and pass 2 own it
    dst = out + row * hd;
  }
  dst += static_cast<size_t>(h) * d;
  const T* xh = x + static_cast<size_t>(h) * d;
  const float* wh = w == nullptr ? nullptr : w + h;

  for (int pass = 0; pass < d; pass += G * KV * V) {
    const int col0 = pass + sub * V;
    float acc[KV][V];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    }

    for (int e0 = begin; e0 < end; e0 += U) {
      int s[U];
      float we[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u;
        s[u] = -1;
        we[u] = 0.f;
        if (e < end) {
          s[u] = __ldg(src + e);
          we[u] = wh == nullptr ? 1.f : __ldg(wh + static_cast<size_t>(e) * num_heads);
        }
      }
      float v[U][KV][V];  // every load first: U * KV row segments in flight
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int col = col0 + k * G * V;
          if (s[u] >= 0 && col < d) {
            Loader<T, V>::load(xh + static_cast<size_t>(s[u]) * hd + col, v[u][k]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) v[u][k][i] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < KV; ++k) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] = fmaf(we[u], v[u][k][i], acc[k][i]);
        }
      }
    }

#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int col = col0 + k * G * V;
      if (col < d) store_vec<V>(dst + col, acc[k]);
    }
  }
}

// Pass 2. Block (l, t) sums columns 32*t .. 32*t + 31 of the partial slots
// long_first[l] .. long_first[l + 1] into out[long_rows[l]]. Warp j takes
// slots j, j + kReduceWarps, ... in order, four loads in flight; lane c of
// warp 0 then adds the kReduceWarps sums in order. f = num_heads * d.
__global__ void __launch_bounds__(kReduceWarps * 32)
split_reduce_kernel(const float* __restrict__ partial,
                    const int32_t* __restrict__ long_rows,
                    const int32_t* __restrict__ long_first,
                    float* __restrict__ out, int f) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int l = blockIdx.x;
  const int col = blockIdx.y * 32 + lane;
  const int last = long_first[l + 1];
  float acc = 0.f;
  if (col < f) {
    const float* p = partial + col;
    const size_t step = static_cast<size_t>(kReduceWarps) * f;
    int c = long_first[l] + wid;
    for (; c + 3 * kReduceWarps < last; c += 4 * kReduceWarps) {
      const float* q = p + static_cast<size_t>(c) * f;
      const float a0 = q[0];
      const float a1 = q[step];
      const float a2 = q[2 * step];
      const float a3 = q[3 * step];
      acc = (((acc + a0) + a1) + a2) + a3;
    }
    for (; c < last; c += kReduceWarps) acc += p[static_cast<size_t>(c) * f];
  }
  sums[wid][lane] = acc;
  __syncthreads();
  if (wid == 0 && col < f) {
    float total = sums[0][lane];
#pragma unroll
    for (int j = 1; j < kReduceWarps; ++j) total += sums[j][lane];
    out[static_cast<size_t>(long_rows[l]) * f + col] = total;
  }
}

struct SplitArgs {
  const void* x;
  const int32_t* src;
  const float* w;  // null: unweighted
  const int32_t* row_offsets;
  const int32_t* chunks;
  const int32_t* long_rows;
  const int32_t* long_first;
  float* out;
  float* partial;
  int num_rows, num_chunks, num_long, num_heads, d, threshold;
  cudaStream_t stream;
};

template <typename T, int V, int G, int KV>
void launch_pass1(const SplitArgs& a) {
  const int64_t tasks = (static_cast<int64_t>(a.num_chunks) + a.num_rows) * a.num_heads;
  constexpr int kTasksPerBlock = kSplitWarps * (32 / G);
  const dim3 grid(static_cast<unsigned>((tasks + kTasksPerBlock - 1) / kTasksPerBlock));
  split_segment_sum_kernel<T, V, G, KV><<<grid, kSplitWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.src, a.w, a.row_offsets, a.chunks, a.out,
      a.partial, a.num_rows, a.num_chunks, a.num_heads, a.d, a.threshold);
}

// Both passes on a.stream; returns the first launch error.
template <typename T, int V>
int launch_split(const SplitArgs& a) {
  if (a.num_rows <= 0 || a.num_heads < 1 || a.d < 1) return 0;
  const int vectors = (a.d + V - 1) / V;  // per head
  if (vectors <= 8) {
    launch_pass1<T, V, 8, 1>(a);
  } else if (vectors <= 16) {
    launch_pass1<T, V, 16, 1>(a);
  } else if (vectors <= 32) {
    launch_pass1<T, V, 32, 1>(a);
  } else if (vectors <= 64) {
    launch_pass1<T, V, 32, 2>(a);
  } else {
    launch_pass1<T, V, 32, 4>(a);
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.num_long == 0) return rc;
  const int f = a.num_heads * a.d;
  const dim3 grid(a.num_long, (f + 31) / 32);
  split_reduce_kernel<<<grid, kReduceWarps * 32, 0, a.stream>>>(
      a.partial, a.long_rows, a.long_first, a.out, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
