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
// Bound: device-memory bytes. K5/K6 read E*H*4 + (N+1)*4 bytes and write
// N*H*4; K7 reads N*H*4 + E*4 and writes E_pad*H*4: a few microseconds at
// ogbn-arxiv shape (7.6 and 9.6 at H = 3 on an H100), the size at which the
// gap between two launches (about 2 us, chip_smoke.py's empty launch) and the
// second pass of K5/K6 are a visible share of the time.
//
// K5/K6 design: one template, the reduction and the head count its
// parameters, over the schedule of graphs/row_split.py (the two passes of
// segment_split.cuh on payloads H floats wide). A unit of work is a whole row
// of at most `threshold` edges or one chunk of a longer row, so a power-law
// hub row of 151k edges is 1,180 independent units and no warp walks it
// alone. The lanes stride the *edges* of a unit: a group of G lanes owns a
// unit (kRowGroup = 4 for a row, whose median length is 6; kChunkGroup = 32
// for a chunk of `threshold` edges), a warp carries 32/G units, neighbouring lanes
// read neighbouring edges and neighbouring groups neighbouring rows, so a
// warp reads one contiguous run of v. A lane starts the loads of kLoads of
// its edges before it combines them, and a fixed-order butterfly of shuffles
// below G combines the lanes of a group. Every lane of a warp takes part in
// the shuffles: a group without a unit (past the end, or a long row in the
// row range) carries the identity and writes nothing; no lane leaves early.
// Pass 1 writes a short row to `out` and a chunk to its slot of `partial`;
// chunks take the first blocks of the grid. Pass 2 gives each long row one
// block, which combines the row's slots in a fixed order into `out`.
// One owner per output element and no float atomics: the same bits at every
// launch, and the max is exact.
//
// K7 design: out is one row of E_pad * H floats, and a thread owns four
// consecutive floats of it, which it writes as one 16-byte store: neighbouring
// threads write neighbouring 16 bytes whatever H is. For each float it finds
// the edge (a division by the template constant H: a multiply), reads
// dst[edge] (neighbouring floats share edges and neighbouring threads read
// neighbouring dst: L1 serves the repeats; at H = 1 the four are one 16-byte
// load where dst is 16-byte aligned) and gathers vals[dst[edge], h] (2 MB at
// arxiv shape: L2; dst is sorted, so neighbours share rows). Four consecutive
// *edges* a thread would read dst once per edge, but put a warp's 16-byte
// stores 16*H bytes apart: half the memory rate at H = 3 (PERF.md). Padding
// edges (past row_offsets[num_rows]) are written 0 and their dst is never
// read.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The lane-group widths and loads in flight, measured against other values
// at ogbn-arxiv shape on an H100: the time follows the number of warps, not
// the bytes (H = 1 takes about what H = 3 takes); 4 lanes a row beat 1, 2,
// 8, 16 and 32 at H = 3, and 2 lanes win only at H = 1 (PERF.md).
constexpr int kRowGroup = 4;     // lanes that own a short row
constexpr int kChunkGroup = 32;  // lanes that own a chunk
constexpr int kLoads = 4;        // edges a lane loads before it combines
constexpr int kLongLoads = 8;           // the same for a thread's slots in pass 2
constexpr int kThinWarps = 8;           // warps per block, both passes
constexpr int kMaxHeads = 8;
constexpr int kTileThreads = 256;
constexpr int kTileFloats = 4;  // floats of out per thread in K7: one 16-byte store
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kRowGroup >= 1 && kRowGroup <= 32 && (kRowGroup & (kRowGroup - 1)) == 0 &&
                  kChunkGroup >= 1 && kChunkGroup <= 32 &&
                  (kChunkGroup & (kChunkGroup - 1)) == 0,
              "a lane group is a power of two within a warp");

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// The reduction over edges begin .. end of v [*, H] by a group of G lanes, of
// which this lane is number `sub`: lane sub takes edges begin + sub,
// begin + sub + kStride, ... in order, kLoadsInFlight at a time, then the
// group's lanes are combined by a butterfly, after which every lane holds the
// group's result. kStride is G, or the block's threads where several warps
// share a unit (then sub is the thread's number and G = 32 combines a warp).
// Every lane of the warp must call this (the shuffles name the whole warp);
// a group with begin == end gets the identity.
template <bool kMax, int H, int G, int kLoadsInFlight, int kStride = G>
__device__ __forceinline__ void reduce_unit(const float* __restrict__ v, int begin,
                                            int end, int sub, float (&acc)[H]) {
  const float init = kMax ? -FLT_MAX : 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = init;
  for (int e0 = begin + sub; e0 < end; e0 += kLoadsInFlight * kStride) {
    float val[kLoadsInFlight][H];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {  // every load first
      const int e = e0 + u * kStride;
      const float* ve = v + static_cast<size_t>(e) * H;
#pragma unroll
      for (int h = 0; h < H; ++h) val[u][h] = e < end ? __ldg(ve + h) : init;
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = combine<kMax>(acc[h], val[u][h]);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      acc[h] = combine<kMax>(acc[h], __shfl_xor_sync(kFullMask, acc[h], off));
    }
  }
}

template <int H>
__device__ __forceinline__ void store_heads(float* __restrict__ dst, const float (&acc)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) dst[h] = acc[h];
}

// Pass 1. Blocks 0 .. chunk_blocks - 1 take the chunks (int32 [num_chunks, 3]:
// row, begin, end) into partial [num_chunks, H]; the others take the rows of
// at most `threshold` edges into out [num_rows, H].
template <bool kMax, int H>
__global__ void __launch_bounds__(kThinWarps * 32)
thin_reduce_units_kernel(const float* __restrict__ v,
                         const int32_t* __restrict__ row_offsets,
                         const int32_t* __restrict__ chunks, float* __restrict__ out,
                         float* __restrict__ partial, int num_rows, int num_chunks,
                         int chunk_blocks, int threshold) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int begin = 0, end = 0;
  float* dst = nullptr;  // stays null for a group without a unit
  float acc[H];
  if (blockIdx.x < chunk_blocks) {  // uniform across the block
    constexpr int G = kChunkGroup;
    const int64_t c =
        (static_cast<int64_t>(blockIdx.x) * kThinWarps + warp) * (32 / G) + lane / G;
    if (c < num_chunks) {
      begin = chunks[3 * c + 1];
      end = chunks[3 * c + 2];
      dst = partial + c * H;
    }
    reduce_unit<kMax, H, G, kLoads>(v, begin, end, lane & (G - 1), acc);
    if (dst != nullptr && (lane & (G - 1)) == 0) store_heads<H>(dst, acc);
  } else {
    constexpr int G = kRowGroup;
    const int64_t r =
        (static_cast<int64_t>(blockIdx.x - chunk_blocks) * kThinWarps + warp) * (32 / G) +
        lane / G;
    if (r < num_rows) {
      begin = row_offsets[r];
      end = row_offsets[r + 1];
      if (end - begin > threshold) {
        end = begin;  // a long row: its chunks and pass 2 own it
      } else {
        dst = out + r * H;
      }
    }
    reduce_unit<kMax, H, G, kLoads>(v, begin, end, lane & (G - 1), acc);
    if (dst != nullptr && (lane & (G - 1)) == 0) store_heads<H>(dst, acc);
  }
}

// Pass 2. Block l combines the partial slots long_first[l] ..
// long_first[l + 1] into out[long_rows[l]]: thread t takes slots t,
// t + 256, ..., a butterfly combines each warp, and thread 0 combines the
// warps' results in order.
template <bool kMax, int H>
__global__ void __launch_bounds__(kThinWarps * 32)
thin_reduce_long_kernel(const float* __restrict__ partial,
                        const int32_t* __restrict__ long_rows,
                        const int32_t* __restrict__ long_first, float* __restrict__ out) {
  __shared__ float warp_acc[kThinWarps][H];
  const int l = blockIdx.x;
  float acc[H];
  reduce_unit<kMax, H, 32, kLongLoads, kThinWarps * 32>(
      partial, long_first[l], long_first[l + 1], threadIdx.x, acc);
  if ((threadIdx.x & 31) == 0) store_heads<H>(warp_acc[threadIdx.x >> 5], acc);
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThinWarps; ++w) {
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = combine<kMax>(acc[h], warp_acc[w][h]);
    }
    store_heads<H>(out + static_cast<size_t>(long_rows[l]) * H, acc);
  }
}

struct ThinArgs {
  const float* v;
  const int32_t* row_offsets;
  const int32_t* chunks;
  const int32_t* long_rows;
  const int32_t* long_first;
  float* out;
  float* partial;
  int num_rows, num_chunks, num_long, threshold;
  cudaStream_t stream;
};

// Both passes on a.stream; returns the first launch error.
template <bool kMax, int H>
int launch_thin_reduce(const ThinArgs& a) {
  constexpr int kChunksPerBlock = kThinWarps * (32 / kChunkGroup);
  constexpr int kRowsPerBlock = kThinWarps * (32 / kRowGroup);
  const int chunk_blocks = (a.num_chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  const int row_blocks = (a.num_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  thin_reduce_units_kernel<kMax, H><<<chunk_blocks + row_blocks, kThinWarps * 32, 0, a.stream>>>(
      a.v, a.row_offsets, a.chunks, a.out, a.partial, a.num_rows, a.num_chunks,
      chunk_blocks, a.threshold);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.num_long == 0) return rc;
  thin_reduce_long_kernel<kMax, H><<<a.num_long, kThinWarps * 32, 0, a.stream>>>(
      a.partial, a.long_rows, a.long_first, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMax>
int launch_thin_reduce_heads(const ThinArgs& a, int num_heads) {
  switch (num_heads) {
    case 1: return launch_thin_reduce<kMax, 1>(a);
    case 2: return launch_thin_reduce<kMax, 2>(a);
    case 3: return launch_thin_reduce<kMax, 3>(a);
    case 4: return launch_thin_reduce<kMax, 4>(a);
    case 5: return launch_thin_reduce<kMax, 5>(a);
    case 6: return launch_thin_reduce<kMax, 6>(a);
    case 7: return launch_thin_reduce<kMax, 7>(a);
    case 8: return launch_thin_reduce<kMax, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7. Thread q owns the four consecutive floats 4q .. 4q + 3 of out, taken as
// one row of E_pad * H floats. dst_aligned: dst is 16-byte aligned, so that at
// H = 1 a thread whose four edges are all real reads them in one load.
template <int H>
__global__ void __launch_bounds__(kTileThreads)
tile_rows_thin_kernel(const float* __restrict__ vals, const int32_t* __restrict__ dst,
                      const int32_t* __restrict__ row_offsets, float* __restrict__ out,
                      int num_rows, int num_out, bool dst_aligned) {
  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * kTileThreads + threadIdx.x) * kTileFloats;
  if (j0 >= num_out) return;
  const int num_real = __ldg(row_offsets + num_rows);
  float o[kTileFloats];
  if (H == 1 && dst_aligned && j0 + kTileFloats <= num_real) {
    const int4 d = __ldg(reinterpret_cast<const int4*>(dst + j0));
    o[0] = __ldg(vals + d.x);
    o[1] = __ldg(vals + d.y);
    o[2] = __ldg(vals + d.z);
    o[3] = __ldg(vals + d.w);
  } else {
#pragma unroll
    for (int k = 0; k < kTileFloats; ++k) {
      const int j = static_cast<int>(j0) + k;  // may pass num_out: then e >= num_real
      const int e = j / H;                     // H is a constant: no division
      o[k] = e < num_real ? __ldg(vals + static_cast<size_t>(__ldg(dst + e)) * H + (j - e * H))
                          : 0.f;  // a padding edge: its dst is never read
    }
  }
  if (j0 + kTileFloats <= num_out) {
    *reinterpret_cast<float4*>(out + j0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {  // the tail, where E_pad * H is not a multiple of 4
#pragma unroll
    for (int k = 0; k < kTileFloats; ++k) {
      if (j0 + k < num_out) out[j0 + k] = o[k];
    }
  }
}

template <int H>
int launch_tile_rows(const float* vals, const int32_t* dst, const int32_t* row_offsets,
                     float* out, int num_rows, int num_edges_padded, cudaStream_t stream) {
  constexpr int kFloatsPerBlock = kTileThreads * kTileFloats;
  const int64_t num_out = static_cast<int64_t>(num_edges_padded) * H;
  if (num_out + kTileFloats > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (num_out + kFloatsPerBlock - 1) / kFloatsPerBlock;
  const bool dst_aligned = reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  tile_rows_thin_kernel<H><<<grid, kTileThreads, 0, stream>>>(
      vals, dst, row_offsets, out, num_rows, static_cast<int>(num_out), dst_aligned);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// v: float32 [E_pad, num_heads], row_offsets int32 [num_rows + 1]; chunks
// int32 [num_chunks, 3], long_rows int32 [num_long], long_first int32
// [num_long + 1]: the row split of row_offsets at `threshold`; out: float32
// [num_rows, num_heads]; partial: float32 scratch [num_chunks, num_heads].
// op: 0 = sum, 1 = max. num_heads <= 8. Returns cudaGetLastError().
int egt_csr_segment_reduce_thin(const void* v, const void* row_offsets, const void* chunks,
                                const void* long_rows, const void* long_first, void* out,
                                void* partial, int num_rows, int num_chunks, int num_long,
                                int num_heads, int threshold, int op, void* stream) {
  if (num_heads < 1 || num_heads > kMaxHeads || (op != 0 && op != 1) || num_rows < 0 ||
      num_chunks < 0 || num_long < 0 || threshold < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return static_cast<int>(cudaGetLastError());
  const ThinArgs a{static_cast<const float*>(v),
                   static_cast<const int32_t*>(row_offsets),
                   static_cast<const int32_t*>(chunks),
                   static_cast<const int32_t*>(long_rows),
                   static_cast<const int32_t*>(long_first),
                   static_cast<float*>(out),
                   static_cast<float*>(partial),
                   num_rows, num_chunks, num_long, threshold,
                   static_cast<cudaStream_t>(stream)};
  return op == 1 ? launch_thin_reduce_heads<true>(a, num_heads)
                 : launch_thin_reduce_heads<false>(a, num_heads);
}

// vals: float32 [num_rows, num_heads], dst int32 [E_pad] (receivers in CSR
// order), row_offsets int32 [num_rows + 1]; out: float32 [E_pad, num_heads],
// 16-byte aligned (the kernel writes it in 16-byte stores). num_heads <= 8.
// Returns cudaGetLastError().
int egt_csr_tile_rows_thin(const void* vals, const void* dst,
                           const void* row_offsets, void* out, int num_rows,
                           int num_edges_padded, int num_heads, void* stream) {
  if (num_heads < 1 || num_heads > kMaxHeads || num_edges_padded < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_edges_padded == 0) return static_cast<int>(cudaGetLastError());
  const float* vf = static_cast<const float*>(vals);
  const int32_t* d = static_cast<const int32_t*>(dst);
  const int32_t* ro = static_cast<const int32_t*>(row_offsets);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (num_heads) {
    case 1: return launch_tile_rows<1>(vf, d, ro, o, num_rows, num_edges_padded, st);
    case 2: return launch_tile_rows<2>(vf, d, ro, o, num_rows, num_edges_padded, st);
    case 3: return launch_tile_rows<3>(vf, d, ro, o, num_rows, num_edges_padded, st);
    case 4: return launch_tile_rows<4>(vf, d, ro, o, num_rows, num_edges_padded, st);
    case 5: return launch_tile_rows<5>(vf, d, ro, o, num_rows, num_edges_padded, st);
    case 6: return launch_tile_rows<6>(vf, d, ro, o, num_rows, num_edges_padded, st);
    case 7: return launch_tile_rows<7>(vf, d, ro, o, num_rows, num_edges_padded, st);
    default: return launch_tile_rows<8>(vf, d, ro, o, num_rows, num_edges_padded, st);
  }
}

// A kernel that does nothing: what one launch costs, the floor under the
// times of K5-K7 (timed by chip_smoke.py). Returns cudaGetLastError().
int egt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
