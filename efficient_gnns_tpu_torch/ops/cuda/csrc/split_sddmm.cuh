// Per-edge row dots over a receiver-sorted CSR, walked row by row on the
// schedule of segment_split.cuh: the template that K3 (segment_sddmm.cu, one
// head) and K4 (segment_heads.cu, H heads) share, in float32 or bfloat16.
//
//   dw[e, h] = sum_c g[r_e, h*D + c] * x[src[e], h*D + c]   for e < num_edges
//   dw[e, h] = 0                                          for the padding edges
//
// where r_e is the row of row_offsets that holds edge e.
//
// Bound: device-memory bytes. An edge costs 2*D flops per head against D
// gathered elements of x, far below the card's flop:byte ratio.
//
// Design. The first design gave every edge its own lanes and read g[r_e]
// once per edge: twice the gathered bytes of K2 at the same shape. Here a
// task is a (unit, head) pair, where a unit is a row of at most `threshold`
// edges or one chunk of `threshold` consecutive edges of a longer row (the
// graph's RowSplit, graphs/row_split.py; chunks first in the grid, so the
// heavy units start first). The task's group of G lanes (8, 16 or 32, the
// fewest that cover the head's D columns in vectors of V elements, as in
// segment_split.cuh) loads its slice of g[r, h, :] once into registers: KV
// vectors of V elements a lane, at D = 250 in float32 8 floats in 8-byte
// loads. It then streams x[src[e], h, :] for the unit's edges with the loads
// of U edges in flight, and reduces each edge's products over the group in
// a fixed butterfly of shuffles. Every output belongs to one edge and every
// edge to one unit, so each output has one owner: no second pass, no
// atomics, and a chunk writes its own edges. An edge's dot is summed in the
// same order whatever unit holds it, so the result is the same bits at every
// launch and with any split.
//
// Heads wider than G*KV*V columns (none on the main path) take several
// passes over the columns, each reloading its slice of g. The shuffles use
// the group's own lane mask, since the groups of a warp walk rows of
// different lengths. Padding edges are written 0 by the first threads of
// the grid and their indices are never read; empty rows read nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_load.cuh"

namespace {

constexpr int kSddmmWarps = 4;  // warps per block

// Edges whose row loads a lane starts before their multiply-adds: about 16
// gathered elements in flight per lane, at most 8 edges. 16 was the fastest
// K4 at D = 250 on the H100 and within 8% of the best K3 (PERF.md).
__host__ __device__ constexpr int sddmm_edges_in_flight(int v, int kv) {
  const int n = 16 / (v * kv);
  return n > 8 ? 8 : (n < 1 ? 1 : n);
}

// Blocks that must fit one SM: 8 (32 warps, at most 64 registers a thread)
// where a lane holds at most 8 elements of g, 6 for the wider heads. K2's cap
// of 48 registers made this kernel spill at D = 250 (1.87-2.07 ms against
// 1.37 at 64 registers on the H100; PERF.md).
__host__ __device__ constexpr int sddmm_min_blocks(int v, int kv) {
  return v * kv > 8 ? 6 : 8;
}

template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return (0xffffffffu >> (32 - G)) << (lane & ~(G - 1));
}

// The lane's KV vectors of one pass over a head's columns (0 past d).
template <typename T, int V, int G, int KV>
__device__ __forceinline__ void load_slice(const T* row, int pass, int sub, int d,
                                           float (&v)[KV][V]) {
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int col = pass + (k * G + sub) * V;
    if (col < d) {
      Loader<T, V>::load(row + col, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.f;
    }
  }
}

// chunks: int32 [num_chunks, 3] (row, begin, end); g: [num_rows, num_heads *
// d]; x: [*, num_heads * d]; out: float32 [num_edges_padded, num_heads].
template <typename T, int V, int G, int KV>
__global__ void __launch_bounds__(kSddmmWarps * 32, sddmm_min_blocks(V, KV))
split_sddmm_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ row_offsets,
                   const int32_t* __restrict__ chunks, float* __restrict__ out,
                   int num_rows, int num_chunks, int num_heads, int d, int threshold,
                   int num_edges, int num_edges_padded) {
  constexpr int U = sddmm_edges_in_flight(V, KV);
  constexpr int P = G * KV * V;  // columns of one pass
  {
    const int64_t pad = static_cast<int64_t>(num_edges_padded - num_edges) * num_heads;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    float* tail = out + static_cast<int64_t>(num_edges) * num_heads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pad;
         i += stride) {
      tail[i] = 0.f;
    }
  }
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kSddmmWarps + (threadIdx.x >> 5);
  const int64_t task = warp * (32 / G) + lane / G;
  const int64_t num_units = static_cast<int64_t>(num_chunks) + num_rows;
  // a group leaves as a whole: its shuffles name its own lanes only
  if (task >= num_units * num_heads) return;
  const int unit = static_cast<int>(task / num_heads);
  const int h = static_cast<int>(task - static_cast<int64_t>(unit) * num_heads);
  int row, begin, end;
  if (unit < num_chunks) {
    row = chunks[3 * unit];
    begin = chunks[3 * unit + 1];
    end = chunks[3 * unit + 2];
  } else {
    row = unit - num_chunks;
    begin = row_offsets[row];
    end = row_offsets[row + 1];
    if (end - begin > threshold) return;  // a long row: its chunks own its edges
  }
  if (begin >= end) return;
  const unsigned mask = group_mask<G>(lane);
  const size_t hd = static_cast<size_t>(num_heads) * d;
  const T* gh = g + static_cast<size_t>(row) * hd + static_cast<size_t>(h) * d;
  const T* xh = x + static_cast<size_t>(h) * d;
  const bool one_pass = d <= P;

  float gv[KV][V];
  if (one_pass) load_slice<T, V, G, KV>(gh, 0, sub, d, gv);
  int s[U];
  for (int e0 = begin; e0 < end; e0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = e0 + u < end ? __ldg(src + e0 + u) : -1;
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    for (int pass = 0; pass < d; pass += P) {
      if (!one_pass) load_slice<T, V, G, KV>(gh, pass, sub, d, gv);
      float v[U][KV][V];  // every load first: U * KV row segments in flight
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s[u] >= 0) {
          load_slice<T, V, G, KV>(xh + static_cast<size_t>(s[u]) * hd, pass, sub, d, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < KV; ++k) {
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
          for (int i = 0; i < V; ++i) acc[u] = fmaf(gv[k][i], v[u][k][i], acc[u]);
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] += __shfl_xor_sync(mask, acc[u], off);
    }
    // every lane holds every sum; lane u of the group stores edge u's
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (sub == u % G && s[u] >= 0) {
        out[static_cast<int64_t>(e0 + u) * num_heads + h] = acc[u];
      }
    }
  }
}

struct SddmmArgs {
  const void* g;
  const void* x;
  const int32_t* src;
  const int32_t* row_offsets;
  const int32_t* chunks;
  float* out;
  int num_rows, num_chunks, num_heads, d, threshold, num_edges, num_edges_padded;
  cudaStream_t stream;
};

template <typename T, int V, int G, int KV>
void launch_sddmm_grid(const SddmmArgs& a) {
  const int64_t tasks = (static_cast<int64_t>(a.num_chunks) + a.num_rows) * a.num_heads;
  constexpr int kTasksPerBlock = kSddmmWarps * (32 / G);
  const int64_t blocks = (tasks + kTasksPerBlock - 1) / kTasksPerBlock;
  split_sddmm_kernel<T, V, G, KV>
      <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kSddmmWarps * 32, 0, a.stream>>>(
          static_cast<const T*>(a.g), static_cast<const T*>(a.x), a.src, a.row_offsets,
          a.chunks, a.out, a.num_rows, a.num_chunks, a.num_heads, a.d, a.threshold,
          a.num_edges, a.num_edges_padded);
}

// One launch on a.stream; returns cudaGetLastError().
template <typename T, int V>
int launch_split_sddmm(const SddmmArgs& a) {
  if (a.num_heads < 1 || a.d < 1 || a.num_edges < 0 || a.num_edges > a.num_edges_padded) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.num_edges_padded == 0) return 0;
  const int vectors = (a.d + V - 1) / V;  // per head
  if (vectors <= 8) {
    launch_sddmm_grid<T, V, 8, 1>(a);
  } else if (vectors <= 16) {
    launch_sddmm_grid<T, V, 16, 1>(a);
  } else if (vectors <= 32) {
    launch_sddmm_grid<T, V, 32, 1>(a);
  } else if (vectors <= 64) {
    launch_sddmm_grid<T, V, 32, 2>(a);
  } else {
    launch_sddmm_grid<T, V, 32, 4>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
