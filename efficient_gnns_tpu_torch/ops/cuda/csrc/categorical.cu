// OGB's AtomEncoder and BondEncoder (models/mol.py::CategoricalEncoder) as
// CUDA kernels: the sum of one embedding row a feature column, forward, and
// every table's gradient from the one cotangent, backward.
//
//   forward   out[r, c] = W_0[k(r, 0), c] + W_1[k(r, 1), c] + ... + W_{T-1}[k(r, T-1), c]
//             k(r, t) = min(max(id[r, t], 0), V_t - 1), added left to right
//   backward  dW_t[v, c] = sum over the rows r with k(r, t) == v of dy[r, c]
//
// Replaces no TPU kernel: the JAX encoder (efficient_gnns_tpu/models/mol.py::
// CategoricalEncoder) is XLA's gathers and adds. PyTorch ran it as T
// F.embedding lookups (19 kernels forward for the 9 atom tables, 7 for the 3
// bond tables) and a backward a table: embedding_backward_feature walks every
// row in ceil(F / 32) blocks, and above 3,072 indices a radix sort comes first.
//
// Forward: bound by writing [R, F] (the tables, a few hundred rows, stay in
// L2). One thread a group of V columns of a row, V = 4, 2 or 1 as F and the
// pointers allow (16-byte loads and stores). The adds are the chain's, in its
// order, so the output has the chain's bits.
//
// Backward: bound by reading dy [R, F] once; the output is sum V_t rows. One
// kernel: a cluster of up to 8 CTAs along the rows owns a slice of 32 columns.
// A CTA stages its rows' bin offsets (the table's first bin + k(r, t)) in
// shared memory; then each of its G row groups walks its rows in order, one
// lane a column, and adds dy[r, c] into the group's own bins [bins][32] in
// shared memory: each element has one writer, so no atomics. The groups' bins
// are summed in group order, then each CTA sums its share of the bins over the
// cluster's CTAs in rank order through distributed shared memory and writes
// it. Every sum runs in a fixed order, so every launch gives the same bits; a
// category that no row takes gets 0. The row count and the vocabularies pick
// the cluster size and G (up to 8 CTAs of up to 16 groups, about 16 rows a
// lane or more, the groups' bins within kBinBudget bytes). The kernel is
// compiled for the two encoders' table counts alone, T = 9 (atoms, 174
// bins) and T = 3 (bonds, 13 bins), so a row's walk is T loads, adds and
// stores and nothing else (on an H100 a loop over 16 guarded tables took two
// to three times as long); every other T is refused.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAtomTables = 9;          // models/mol.py's ATOM_FEATURE_DIMS
constexpr int kBondTables = 3;          // and BOND_FEATURE_DIMS: the only table counts
constexpr int kMaxTables = kAtomTables;
constexpr int kFwdThreads = 256;
constexpr int kLanes = 32;              // backward: columns of a CTA's slice
constexpr int kMaxGroups = 16;          // backward: row groups of a CTA
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kStageRows = 512;         // backward: rows whose bins a CTA stages at once
constexpr int kRowsPerLane = 16;        // backward: the fewest rows a lane aims to walk
constexpr int kBatch = 8;               // backward: dy values a lane loads before it adds
constexpr int kBinBudget = 160 * 1024;  // backward: shared bytes for the groups' bins
constexpr int kMaxBins = 256;           // the atom tables' 174 rows, with room: 32 KiB a group

struct Tables {
  const float* w[kMaxTables];  // forward: the tables, [V_t, F] each
  int vocab[kMaxTables];
  int first[kMaxTables];  // backward: the table's first bin, the vocabularies before it
  int count;              // T
};

__device__ __forceinline__ int clip(int id, int vocab) { return min(max(id, 0), vocab - 1); }

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&in)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  else
    *p = in[0];
}

// ---- forward: one thread a V-column group of a row, every row ----

template <int V>
__global__ void __launch_bounds__(kFwdThreads)
    categorical_encode_kernel(const int* __restrict__ ids, Tables tb, float* __restrict__ out,
                              int rows, int f) {
  const int groups = f / V;
  const int i = blockIdx.x * kFwdThreads + threadIdx.x;
  if (i >= rows * groups) return;
  const int r = i / groups;
  const int c = (i - r * groups) * V;
  const int* id = ids + static_cast<int64_t>(r) * tb.count;
  float acc[V], add[V];
  load_v<V>(tb.w[0] + static_cast<int64_t>(clip(__ldg(id), tb.vocab[0])) * f + c, acc);
#pragma unroll
  for (int t = 1; t < kMaxTables; ++t) {
    if (t >= tb.count) break;
    load_v<V>(tb.w[t] + static_cast<int64_t>(clip(__ldg(id + t), tb.vocab[t])) * f + c, add);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], add[j]);
  }
  store_v<V>(out + static_cast<int64_t>(r) * f + c, acc);
}

// ---- backward: a cluster along the rows a 32-column slice ----

struct Grad {
  const float* dy;  // [rows, f]
  const int* ids;   // [rows, T]
  float* dw;        // [bins, f]
  int rows, f, bins;
  Tables tb;
};

// dy[u, c] of rows u0 .. u0 + kBatch - 1 below z (0 past z or off the columns).
__device__ __forceinline__ void load_batch(float (&d)[kBatch], const float* dy, int u0, int z,
                                           bool live, int f) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    d[j] = (live && u0 + j < z) ? __ldg(dy + static_cast<int64_t>(u0 + j) * f) : 0.0f;
}

// Columns of a staged row: the row's T bin offsets, padded to whole 16-byte loads.
template <int T>
constexpr int kStageStride = (T + 3) / 4 * 4;

template <int T>
__global__ void __launch_bounds__(kMaxGroups * kLanes) categorical_grad_kernel(Grad p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const int groups = blockDim.x / kLanes;
  const int col = blockIdx.y * kLanes + lane;
  const bool live = col < p.f;
  const int bins = p.bins, stride = bins * kLanes;
  float* mine = smem + group * stride + lane;  // this lane's column of its group's bins
  // a staged row: the offset in a group's bins (bin * kLanes) of each table
  int* stage = reinterpret_cast<int*>(smem + groups * stride);
  for (int b = 0; b < bins; ++b) mine[b * kLanes] = 0.0f;

  const int per = (p.rows + cl - 1) / cl;
  const int r0 = min(p.rows, rank * per), r1 = min(p.rows, r0 + per);
  for (int s0 = r0; s0 < r1; s0 += kStageRows) {
    const int n = min(kStageRows, r1 - s0);
    const int each = (n + groups - 1) / groups;
    const int a = min(n, group * each), z = min(n, a + each);
    const float* dy = p.dy + static_cast<int64_t>(s0) * p.f + col;
    float d[kBatch];
    load_batch(d, dy, a, z, live, p.f);  // in flight while the stage is filled
    __syncthreads();                     // the previous stage is walked
    const int* ids = p.ids + static_cast<int64_t>(s0) * T;
    for (int i = threadIdx.x; i < n * T; i += blockDim.x) {
      const int u = i / T, t = i - u * T;
      const int bin = p.tb.first[t] + clip(__ldg(ids + i), p.tb.vocab[t]);
      stage[u * kStageStride<T> + t] = bin * kLanes;
    }
    __syncthreads();
    for (int u0 = a; u0 < z; u0 += kBatch) {
      float next[kBatch];
      load_batch(next, dy, u0 + kBatch, z, live, p.f);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (u0 + j >= z) break;
        // the row's T bins are distinct (each table has its own): all are
        // loaded before any is stored
        int k[kStageStride<T>];
        const int4* row = reinterpret_cast<const int4*>(stage + (u0 + j) * kStageStride<T>);
#pragma unroll
        for (int q = 0; q < kStageStride<T> / 4; ++q) {
          const int4 w = row[q];
          k[4 * q] = w.x, k[4 * q + 1] = w.y, k[4 * q + 2] = w.z, k[4 * q + 3] = w.w;
        }
        float v[T];
#pragma unroll
        for (int t = 0; t < T; ++t) v[t] = mine[k[t]];
#pragma unroll
        for (int t = 0; t < T; ++t) mine[k[t]] = __fadd_rn(v[t], d[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) d[j] = next[j];
    }
  }
  __syncthreads();
  // the groups' bins into group 0's, in group order
  for (int e = threadIdx.x; e < stride; e += blockDim.x) {
    float s = smem[e];
#pragma unroll 4
    for (int g = 1; g < groups; ++g) s = __fadd_rn(s, smem[g * stride + e]);
    smem[e] = s;
  }
  cluster.sync();
  // this CTA's share of the bins, over the cluster's CTAs in rank order
  const int share = (bins + cl - 1) / cl;
  const int b0 = min(bins, rank * share), b1 = min(bins, b0 + share);
  for (int e = b0 * kLanes + static_cast<int>(threadIdx.x); e < b1 * kLanes; e += blockDim.x) {
    float part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < cl ? *cluster.map_shared_rank(smem + e, q) : 0.0f;
    float s = part[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < cl) s = __fadd_rn(s, part[q]);
    if (live) p.dw[static_cast<int64_t>(e / kLanes) * p.f + col] = s;
  }
  cluster.sync();  // no CTA leaves while another reads its bins
}

using GradKernel = void (*)(Grad);

inline GradKernel grad_kernel(int t) {
  return t == kAtomTables ? categorical_grad_kernel<kAtomTables>
                          : categorical_grad_kernel<kBondTables>;
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// The tables' vocabularies and first bins; false if T is neither encoder's
// or a vocabulary is out of range.
inline bool fill(Tables* tb, const int* vocab, int t, int* bins) {
  if (t != kAtomTables && t != kBondTables) return false;
  *bins = 0;
  for (int i = 0; i < t; ++i) {
    if (vocab[i] < 1) return false;
    tb->vocab[i] = vocab[i];
    tb->first[i] = *bins;
    *bins += vocab[i];
  }
  tb->count = t;
  return *bins <= kMaxBins;
}

// (cluster size, row groups) of the backward for `rows` rows and `bins` bins.
inline void plan(int rows, int bins, int* cl, int* groups) {
  const int most = max(1, min(kMaxGroups, kBinBudget / (bins * kLanes * 4)));
  const int c = (rows + most * kRowsPerLane - 1) / (most * kRowsPerLane);
  *cl = max(1, min(kMaxCluster, c));
  const int per = (rows + *cl - 1) / *cl;
  *groups = max(1, min(most, (per + kRowsPerLane - 1) / kRowsPerLane));
}

}  // namespace

extern "C" {

// Every pointer is a device pointer but `tables` and `vocab`, host arrays of T
// entries, T = 9 or 3: the tables' device pointers (float32 [V_t, F] each)
// and their vocabularies V_t, at most kMaxBins together. ids are int32 [rows,
// T], out and dy float32 [rows, F], dw float32 [sum V_t, F] (table t's rows
// from its first bin on). `vec` (4, 2 or 1) divides F and aligns every table
// and out. The caller checks shapes, devices and contiguity. Each returns
// cudaGetLastError() after its launch (0 with nothing to do); another T, or
// more bins, is cudaErrorInvalidValue.

int egt_categorical_max_bins() { return kMaxBins; }

int egt_categorical_encode(const void* ids, const void* tables, const void* vocab, void* out,
                           int rows, int t, int f, int vec, void* stream) {
  Tables tb{};
  int bins = 0;
  if (!fill(&tb, static_cast<const int*>(vocab), t, &bins) ||
      (vec != 1 && vec != 2 && vec != 4) || f % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || f == 0) return 0;
  const auto* w = static_cast<const void* const*>(tables);
  for (int i = 0; i < t; ++i) tb.w[i] = static_cast<const float*>(w[i]);
  const int threads = rows * (f / vec);
  const dim3 grid((threads + kFwdThreads - 1) / kFwdThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int*>(ids);
  auto* o = static_cast<float*>(out);
  if (vec == 4)
    categorical_encode_kernel<4><<<grid, kFwdThreads, 0, st>>>(id, tb, o, rows, f);
  else if (vec == 2)
    categorical_encode_kernel<2><<<grid, kFwdThreads, 0, st>>>(id, tb, o, rows, f);
  else
    categorical_encode_kernel<1><<<grid, kFwdThreads, 0, st>>>(id, tb, o, rows, f);
  return last_error();
}

int egt_categorical_grad(const void* dy, const void* ids, const void* vocab, void* dw, int rows,
                         int t, int f, void* stream) {
  Grad p{};
  int bins = 0;
  if (!fill(&p.tb, static_cast<const int*>(vocab), t, &bins))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f == 0) return 0;
  p.dy = static_cast<const float*>(dy);
  p.ids = static_cast<const int*>(ids);
  p.dw = static_cast<float*>(dw);
  p.rows = rows, p.f = f, p.bins = bins;
  int cl = 1, groups = 1;
  plan(rows, bins, &cl, &groups);
  const int smem = groups * bins * kLanes * 4 + kStageRows * ((t + 3) / 4 * 4) * 4;
  const GradKernel kernel = grad_kernel(t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (f + kLanes - 1) / kLanes, 1);
  cfg.blockDim = dim3(groups * kLanes, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return e != cudaSuccess ? static_cast<int>(e) : last_error();
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
