// MaskedBatchNorm (models/layers.py) as CUDA kernels: the batch statistics
// over the masked rows, the normalisation, the affine and an optional ReLU,
// forward and backward, and the eval-mode pass.
//
//   forward   mean, var over the rows of mask (all rows without one)
//             y = act((x - mean) * rstd * scale + bias),  rstd = 1/sqrt(var + eps)
//             running = running * momentum + (1 - momentum) * batch statistic
//   backward  dz = dy * [z > 0] (ReLU) or dy;  xh = (x - mean) * rstd
//             dbias = sum dz, dscale = sum dz * xh   (every row)
//             dx = scale * rstd * (dz - dbias / c - xh * dscale / c)  (rows of mask)
//             dx = scale * rstd * dz                                   (the others)
//   eval      y = act((x - running_mean) * rsqrt(running_var + eps) * scale + bias)
//
// Replaces no TPU kernel: the JAX layer (flax, efficient_gnns_tpu/models/
// layers.py::MaskedBatchNorm) is XLA elementwise work and reductions, which
// PyTorch runs as about 26 kernels forward and 30 backward, each at its
// launch floor at the molhiv batch's [1280, 600] and each a full pass over
// [N, F] at ogbn-arxiv's N = 169,343.
//
// Bound: device-memory bytes. Two designs, picked by the row count alone:
//
// - n <= kSmallRows (2048; the molhiv batches' 1,280 atoms and 32 graphs):
//   one kernel a direction. A cluster of up to 8 CTAs along the rows owns a
//   slice of 16 columns; each CTA keeps its tile of at most 256 rows in
//   registers, reduces it, and the CTAs exchange their partials over
//   distributed shared memory, so x (and dy) is read from device memory once.
// - larger n (ogbn-arxiv): two kernels a direction. The first writes one
//   partial a chunk of rows and column into a [chunks, F] scratch; the
//   second merges its columns' partials and normalises (or differentiates)
//   its chunk: forward 2 reads and 1 write of [N, F], backward 4 reads and 1
//   write. A CTA takes 32 threads along the columns, each with V = 4, 2 or 1
//   consecutive columns (as F allows), so a warp reads 128 V consecutive
//   bytes of a row; the caller aims at about 256 CTAs (measured on an H100:
//   more chunks make the second kernel's merge the bottleneck, fewer starve
//   the first). Where a row is not a multiple of 32 bytes (F = 750), the
//   column slices' edges split sectors of the output between CTAs, which
//   keeps the forward near 65% of its traffic's time against 72-83% at F =
//   256.
//
// Statistics: per-tile (count, mean, M2) taken in two passes over values in
// registers, merged by Chan's formula; var = M2 / count, the biased
// variance as the mean squared deviation (no E[x^2] - E[x]^2 cancellation).
// Every merge and sum runs in a fixed order (tile, row group, CTA or chunk),
// so two runs give the same bits, every CTA of a column slice computes the
// same statistics, and no float atomics are used. The arithmetic is rounded
// step by step with the _rn intrinsics, so the backward recomputes z with the
// forward's bits and takes its ReLU mask from them instead of storing y.
// count 0 gives mean 0 and var 0, as the layer's clamp of the count to 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;                  // two-kernel path: threads along the columns
constexpr int kGroups = kThreads / kLanes;  // two-kernel path: row groups of a CTA
constexpr int kTile = 16;         // values of x a thread loads before it computes
constexpr int kSmallLanes = 16;   // one-kernel path: columns of a CTA
constexpr int kSmallGroups = 16;  // one-kernel path: row groups of a CTA
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kSmallRows = kMaxCluster * kSmallGroups * kTile;  // 2048

struct Stat {
  float n, mean, m2;
};

struct Sums {
  float dz, dzx, n;
};

// Chan's merge of two (count, mean, M2) partials.
__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = __fadd_rn(a.n, b.n);
  const float wb = __fdiv_rn(b.n, n);
  const float delta = __fsub_rn(b.mean, a.mean);
  return {n, __fadd_rn(a.mean, __fmul_rn(delta, wb)),
          __fadd_rn(__fadd_rn(a.m2, b.m2), __fmul_rn(__fmul_rn(delta, delta), __fmul_rn(a.n, wb)))};
}

__device__ __forceinline__ Sums add(const Sums& a, const Sums& b) {
  return {__fadd_rn(a.dz, b.dz), __fadd_rn(a.dzx, b.dzx), __fadd_rn(a.n, b.n)};
}

// (count, mean, M2) of the kept values of column j of a tile of R rows and V
// columns, two passes in registers.
template <int R, int V>
__device__ __forceinline__ Stat tile_stat(const float (&v)[R][V], const bool (&keep)[R], int j) {
  float n = 0.0f, s = 0.0f;
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (keep[u]) {
      n = __fadd_rn(n, 1.0f);
      s = __fadd_rn(s, v[u][j]);
    }
  if (n == 0.0f) return {0.0f, 0.0f, 0.0f};
  const float mean = __fdiv_rn(s, n);
  float m2 = 0.0f;
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (keep[u]) {
      const float d = __fsub_rn(v[u][j], mean);
      m2 = __fadd_rn(m2, __fmul_rn(d, d));
    }
  return {n, mean, m2};
}

// V consecutive floats, one load or store (the caller keeps p V-aligned).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = *p;
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

struct Col {
  float mean, rstd, scale, bias;
  // z = (x - mean) * rstd * scale + bias, the forward's rounding
  __device__ __forceinline__ float xhat(float x) const {
    return __fmul_rn(__fsub_rn(x, mean), rstd);
  }
  __device__ __forceinline__ float z(float xh) const {
    return __fadd_rn(__fmul_rn(xh, scale), bias);
  }
};

struct Fwd {
  const float* x;
  const uint8_t* mask;  // null: every row
  const float* scale;
  const float* bias;
  float* y;
  float* mean;           // [F] out: the batch mean (eval: the running mean)
  float* rstd;           // [F] out
  float* running_mean;   // [F] in/out (eval: in)
  float* running_var;
  int n, f, relu;
  float momentum, keep_frac, eps;  // keep_frac = 1 - momentum, as the caller rounds it
};

struct Bwd {
  const float* dy;
  const float* x;
  const uint8_t* mask;
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* bias;
  float* dx;
  float* dscale;
  float* dbias;
  int n, f, relu, frozen;  // frozen: eval mode, no row in the statistics
};

__device__ __forceinline__ bool kept(const uint8_t* mask, int row) {
  return mask == nullptr || mask[row] != 0;
}

__device__ __forceinline__ float act(float z, int relu) {
  return relu ? fmaxf(z, 0.0f) : z;
}

// The batch statistics of a column from its merged partial: writes mean and
// rstd (and steps the running statistics) when `write`.
__device__ __forceinline__ Col finish(const Fwd& p, const Stat& t, int col, bool write) {
  const float var = t.n > 0.0f ? __fdiv_rn(t.m2, t.n) : 0.0f;
  const float mean = t.n > 0.0f ? t.mean : 0.0f;
  const Col c{mean, __frsqrt_rn(__fadd_rn(var, p.eps)), p.scale[col], p.bias[col]};
  if (write) {
    p.mean[col] = mean;
    p.rstd[col] = c.rstd;
    p.running_mean[col] = __fadd_rn(__fmul_rn(p.running_mean[col], p.momentum),
                                    __fmul_rn(p.keep_frac, mean));
    p.running_var[col] = __fadd_rn(__fmul_rn(p.running_var[col], p.momentum),
                                   __fmul_rn(p.keep_frac, var));
  }
  return c;
}

__device__ __forceinline__ Col load_col(const Bwd& q, int col) {
  return {q.mean[col], q.rstd[col], q.scale[col], q.bias[col]};
}

__device__ __forceinline__ float grad_in(const Bwd& q, const Col& c, float x, float dy,
                                         float* xh) {
  *xh = c.xhat(x);
  return (q.relu && !(c.z(*xh) > 0.0f)) ? 0.0f : dy;
}

// dx of one row from its dz and xh and the column's sums over the rows.
__device__ __forceinline__ float grad_out(const Col& c, float dz, float xh, bool in_stats,
                                          float a, float b) {
  const float gr = __fmul_rn(c.scale, c.rstd);
  if (!in_stats) return __fmul_rn(gr, dz);
  return __fmul_rn(gr, __fsub_rn(__fsub_rn(dz, a), __fmul_rn(xh, b)));
}

// ---- one kernel a direction: n <= kSmallRows, a cluster along the rows ----
//
// A CTA of the cluster takes rows [r0, r1) of the column slice: kSmallGroups
// row groups of kSmallLanes columns, kTile rows a thread at most. Its partial
// is a tree over the row groups in shared memory; then every CTA reads all
// the cluster's partials (one remote read a thread) and merges them by the
// same tree, so every CTA normalises with the same bits. A CTA arrives on the
// cluster barrier once it has read, and waits on it only before it exits, so
// that its partial outlives the others' reads while its stores go ahead.

__device__ __forceinline__ void cluster_rows(int n, int* r0, int* r1) {
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (n + static_cast<int>(cluster.num_blocks()) - 1) /
                  static_cast<int>(cluster.num_blocks());
  *r0 = static_cast<int>(cluster.block_rank()) * per;
  *r1 = min(n, *r0 + per);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ Stat combine(const Stat& a, const Stat& b) { return merge(a, b); }
__device__ __forceinline__ Sums combine(const Sums& a, const Sums& b) { return add(a, b); }

// part[g][lane] of every row group, then of every CTA of the cluster, merged
// by a fixed tree: returns with the cluster's total in total[lane] (read it
// after the __syncthreads the caller does), every CTA the same bits.
template <typename T>
__device__ __forceinline__ void cluster_total(T (&part)[kSmallGroups][kSmallLanes],
                                              T (&ranks)[kMaxCluster][kSmallLanes], int g,
                                              int lane) {
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
#pragma unroll
  for (int s = kSmallGroups / 2; s > 0; s >>= 1) {
    if (g < s) part[g][lane] = combine(part[g][lane], part[g + s][lane]);
    __syncthreads();
  }
  cluster.sync();  // every CTA's part[0] is its partial
  if (g < kMaxCluster)
    ranks[g][lane] = g < static_cast<int>(cluster.num_blocks())
                         ? cluster.map_shared_rank(&part[0][0], g)[lane]
                         : T{0.0f, 0.0f, 0.0f};
  cluster_arrive();
  __syncthreads();
#pragma unroll
  for (int s = kMaxCluster / 2; s > 0; s >>= 1) {
    if (g < s) ranks[g][lane] = combine(ranks[g][lane], ranks[g + s][lane]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) masked_bn_fused_kernel(Fwd p) {
  __shared__ Stat part[kSmallGroups][kSmallLanes];
  __shared__ Stat ranks[kMaxCluster][kSmallLanes];
  __shared__ Col cols[kSmallLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % kSmallLanes, g = threadIdx.x / kSmallLanes;
  const int col = blockIdx.y * kSmallLanes + lane;
  const bool active = col < p.f;
  int r0, r1;
  cluster_rows(p.n, &r0, &r1);
  float v[kTile][1];
  bool keep[kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
    const int row = r0 + g + kSmallGroups * u;
    const bool in = active && row < r1;
    v[u][0] = in ? p.x[static_cast<long long>(row) * p.f + col] : 0.0f;
    keep[u] = in && kept(p.mask, row);
  }
  part[g][lane] = tile_stat(v, keep, 0);
  cluster_total(part, ranks, g, lane);
  if (g == 0 && active) cols[lane] = finish(p, ranks[0][lane], col, cluster.block_rank() == 0);
  __syncthreads();
  if (active) {
    const Col c = cols[lane];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int row = r0 + g + kSmallGroups * u;
      if (row < r1)
        p.y[static_cast<long long>(row) * p.f + col] = act(c.z(c.xhat(v[u][0])), p.relu);
    }
  }
  cluster_wait();  // the other CTAs have read this one's partial
}

__global__ void __launch_bounds__(kThreads) masked_bn_grad_fused_kernel(Bwd q) {
  __shared__ Sums part[kSmallGroups][kSmallLanes];
  __shared__ Sums ranks[kMaxCluster][kSmallLanes];
  __shared__ float2 ab[kSmallLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % kSmallLanes, g = threadIdx.x / kSmallLanes;
  const int col = blockIdx.y * kSmallLanes + lane;
  const bool active = col < q.f;
  int r0, r1;
  cluster_rows(q.n, &r0, &r1);
  const Col c = active ? load_col(q, col) : Col{0.0f, 0.0f, 0.0f, 0.0f};
  float dz[kTile], xh[kTile];
  Sums s{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
    const int row = r0 + g + kSmallGroups * u;
    const bool in = active && row < r1;
    const long long i = static_cast<long long>(row) * q.f + col;
    dz[u] = in ? grad_in(q, c, q.x[i], q.dy[i], &xh[u]) : 0.0f;
    if (!in) xh[u] = 0.0f;
    s = add(s, {dz[u], __fmul_rn(dz[u], xh[u]), in && !q.frozen && kept(q.mask, row) ? 1.0f : 0.0f});
  }
  part[g][lane] = s;
  cluster_total(part, ranks, g, lane);
  if (g == 0 && active) {
    const Sums t = ranks[0][lane];
    const float cnt = fmaxf(t.n, 1.0f);
    ab[lane] = make_float2(__fdiv_rn(t.dz, cnt), __fdiv_rn(t.dzx, cnt));
    if (cluster.block_rank() == 0) {
      q.dbias[col] = t.dz;
      q.dscale[col] = t.dzx;
    }
  }
  __syncthreads();
  if (active) {
    const float2 w = ab[lane];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int row = r0 + g + kSmallGroups * u;
      if (row < r1)
        q.dx[static_cast<long long>(row) * q.f + col] =
            grad_out(c, dz[u], xh[u], !q.frozen && kept(q.mask, row), w.x, w.y);
    }
  }
  cluster_wait();
}

// ---- two kernels a direction: partials a chunk of rows, then merge + apply ----
//
// A CTA owns kLanes * V columns and a chunk of rows: kLanes threads along the
// columns, each with V consecutive columns (one V-wide load a row; V = 4, 2
// or 1 as F allows), and kGroups row groups. A thread loads R = kTile / V
// rows of its columns before it computes.

struct Chunk {
  int r0, r1;
};

__device__ __forceinline__ Chunk chunk_rows(int n, int rows_per_chunk) {
  const int r0 = blockIdx.y * rows_per_chunk;
  return {r0, min(n, r0 + rows_per_chunk)};
}

struct Place {  // a thread's columns and row group
  int lane, g, col;  // col: the first of its V columns
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(int f) {
  const int lane = threadIdx.x % kLanes;
  const int col = (blockIdx.x * kLanes + lane) * V;
  return {lane, static_cast<int>(threadIdx.x) / kLanes, col, col < f};  // f % V == 0
}

__device__ __forceinline__ long long at(int row, int f, int col) {
  return static_cast<long long>(row) * f + col;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
masked_bn_partials_kernel(Fwd p, float* __restrict__ pmean, float* __restrict__ pm2,
                          float* __restrict__ pcount, int rows_per_chunk) {
  constexpr int R = kTile / V;
  __shared__ Stat part[kGroups][kLanes * V];
  const Place t = place<V>(p.f);
  const Chunk ch = chunk_rows(p.n, rows_per_chunk);
  Stat s[V] = {};
  for (int base = ch.r0 + t.g; base < ch.r1; base += kGroups * R) {
    float v[R][V];
    bool keep[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      const bool in = row < ch.r1;
      if (in && t.active) {
        load_v<V>(p.x + at(row, p.f, t.col), v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[u][j] = 0.0f;
      }
      keep[u] = in && kept(p.mask, row);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = merge(s[j], tile_stat(v, keep, j));
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[t.g][t.lane * V + j] = s[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kLanes * V; c += kThreads) {
    Stat m = part[0][c];
    for (int k = 1; k < kGroups; ++k) m = merge(m, part[k][c]);
    const int col = blockIdx.x * kLanes * V + c;
    if (col < p.f) {
      pmean[at(blockIdx.y, p.f, col)] = m.mean;
      pm2[at(blockIdx.y, p.f, col)] = m.m2;
    }
    if (blockIdx.x == 0 && c == 0) pcount[blockIdx.y] = m.n;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
masked_bn_apply_kernel(Fwd p, const float* __restrict__ pmean, const float* __restrict__ pm2,
                       const float* __restrict__ pcount, int chunks, int rows_per_chunk) {
  constexpr int R = kTile / V;
  __shared__ Stat part[kGroups][kLanes * V];
  __shared__ Col cols[kLanes * V];
  const Place t = place<V>(p.f);
  Stat s[V] = {};
  if (t.active)
    for (int k = t.g; k < chunks; k += kGroups) {
      float mv[V], m2[V];
      load_v<V>(pmean + at(k, p.f, t.col), mv);
      load_v<V>(pm2 + at(k, p.f, t.col), m2);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = merge(s[j], {pcount[k], mv[j], m2[j]});
    }
#pragma unroll
  for (int j = 0; j < V; ++j) part[t.g][t.lane * V + j] = s[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kLanes * V; c += kThreads) {
    const int col = blockIdx.x * kLanes * V + c;
    if (col >= p.f) continue;
    Stat m = part[0][c];
    for (int k = 1; k < kGroups; ++k) m = merge(m, part[k][c]);
    cols[c] = finish(p, m, col, blockIdx.y == 0);
  }
  __syncthreads();
  if (!t.active) return;
  Col cc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) cc[j] = cols[t.lane * V + j];
  const Chunk ch = chunk_rows(p.n, rows_per_chunk);
  for (int base = ch.r0 + t.g; base < ch.r1; base += kGroups * R) {
    float v[R][V];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row < ch.r1) load_v<V>(p.x + at(row, p.f, t.col), v[u]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row >= ch.r1) break;
#pragma unroll
      for (int j = 0; j < V; ++j) v[u][j] = act(cc[j].z(cc[j].xhat(v[u][j])), p.relu);
      store_v<V>(p.y + at(row, p.f, t.col), v[u]);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
masked_bn_grad_partials_kernel(Bwd q, float* __restrict__ pdz, float* __restrict__ pdzx,
                               float* __restrict__ pcount, int rows_per_chunk) {
  constexpr int R = kTile / V;
  __shared__ Sums part[kGroups][kLanes * V];
  const Place t = place<V>(q.f);
  Col cc[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    cc[j] = t.active ? load_col(q, t.col + j) : Col{0.0f, 0.0f, 0.0f, 0.0f};
  const Chunk ch = chunk_rows(q.n, rows_per_chunk);
  Sums s[V] = {};
  for (int base = ch.r0 + t.g; base < ch.r1; base += kGroups * R) {
    float xv[R][V], gv[R][V];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row < ch.r1 && t.active) {
        load_v<V>(q.x + at(row, q.f, t.col), xv[u]);
        load_v<V>(q.dy + at(row, q.f, t.col), gv[u]);
      }
    }
    Sums tile[V] = {};
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row >= ch.r1) break;
      const float in_stats = !q.frozen && kept(q.mask, row) ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float xh = 0.0f;
        const float dz = t.active ? grad_in(q, cc[j], xv[u][j], gv[u][j], &xh) : 0.0f;
        tile[j] = add(tile[j], {dz, __fmul_rn(dz, xh), in_stats});
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = add(s[j], tile[j]);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[t.g][t.lane * V + j] = s[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kLanes * V; c += kThreads) {
    Sums m = part[0][c];
    for (int k = 1; k < kGroups; ++k) m = add(m, part[k][c]);
    const int col = blockIdx.x * kLanes * V + c;
    if (col < q.f) {
      pdz[at(blockIdx.y, q.f, col)] = m.dz;
      pdzx[at(blockIdx.y, q.f, col)] = m.dzx;
    }
    if (blockIdx.x == 0 && c == 0) pcount[blockIdx.y] = m.n;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
masked_bn_grad_apply_kernel(Bwd q, const float* __restrict__ pdz,
                            const float* __restrict__ pdzx, const float* __restrict__ pcount,
                            int chunks, int rows_per_chunk) {
  constexpr int R = kTile / V;
  __shared__ Sums part[kGroups][kLanes * V];
  __shared__ float2 ab[kLanes * V];
  const Place t = place<V>(q.f);
  Sums s[V] = {};
  if (t.active)
    for (int k = t.g; k < chunks; k += kGroups) {
      float a[V], b[V];
      load_v<V>(pdz + at(k, q.f, t.col), a);
      load_v<V>(pdzx + at(k, q.f, t.col), b);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = add(s[j], {a[j], b[j], pcount[k]});
    }
#pragma unroll
  for (int j = 0; j < V; ++j) part[t.g][t.lane * V + j] = s[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kLanes * V; c += kThreads) {
    const int col = blockIdx.x * kLanes * V + c;
    if (col >= q.f) continue;
    Sums m = part[0][c];
    for (int k = 1; k < kGroups; ++k) m = add(m, part[k][c]);
    const float cnt = fmaxf(m.n, 1.0f);
    ab[c] = make_float2(__fdiv_rn(m.dz, cnt), __fdiv_rn(m.dzx, cnt));
    if (blockIdx.y == 0) {
      q.dbias[col] = m.dz;
      q.dscale[col] = m.dzx;
    }
  }
  __syncthreads();
  if (!t.active) return;
  Col cc[V];
  float2 w[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    cc[j] = load_col(q, t.col + j);
    w[j] = ab[t.lane * V + j];
  }
  const Chunk ch = chunk_rows(q.n, rows_per_chunk);
  for (int base = ch.r0 + t.g; base < ch.r1; base += kGroups * R) {
    float xv[R][V], gv[R][V];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row < ch.r1) {
        load_v<V>(q.x + at(row, q.f, t.col), xv[u]);
        load_v<V>(q.dy + at(row, q.f, t.col), gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row >= ch.r1) break;
      const bool in_stats = !q.frozen && kept(q.mask, row);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float xh;
        const float dz = grad_in(q, cc[j], xv[u][j], gv[u][j], &xh);
        xv[u][j] = grad_out(cc[j], dz, xh, in_stats, w[j].x, w[j].y);
      }
      store_v<V>(q.dx + at(row, q.f, t.col), xv[u]);
    }
  }
}

// ---- eval mode: one elementwise pass with the running statistics ----

template <int V>
__global__ void __launch_bounds__(kThreads) masked_bn_eval_kernel(Fwd p, int rows_per_chunk) {
  constexpr int R = kTile / V;
  const Place t = place<V>(p.f);
  if (!t.active) return;
  Col cc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int col = t.col + j;
    cc[j] = {p.running_mean[col], __frsqrt_rn(__fadd_rn(p.running_var[col], p.eps)),
             p.scale[col], p.bias[col]};
    if (blockIdx.y == 0 && t.g == 0) {
      p.mean[col] = cc[j].mean;
      p.rstd[col] = cc[j].rstd;
    }
  }
  const Chunk ch = chunk_rows(p.n, rows_per_chunk);
  for (int base = ch.r0 + t.g; base < ch.r1; base += kGroups * R) {
    float v[R][V];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row < ch.r1) load_v<V>(p.x + at(row, p.f, t.col), v[u]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = base + kGroups * u;
      if (row >= ch.r1) break;
#pragma unroll
      for (int j = 0; j < V; ++j) v[u][j] = act(cc[j].z(cc[j].xhat(v[u][j])), p.relu);
      store_v<V>(p.y + at(row, p.f, t.col), v[u]);
    }
  }
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

inline int cluster_size(int n) {
  return n <= 0 ? 1 : min(kMaxCluster, (n + 127) / 128);
}

template <typename Params>
int launch_cluster(void (*kernel)(Params), const Params& args, int n, int f, void* stream) {
  const int cl = cluster_size(n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (f + kSmallLanes - 1) / kSmallLanes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  return e != cudaSuccess ? static_cast<int>(e) : last_error();
}

inline dim3 chunk_grid(int f, int vec, int chunks) {
  return dim3((f + kLanes * vec - 1) / (kLanes * vec), chunks, 1);
}

// Launches kernel<V> for the vector width vec (4, 2 or 1; F a multiple of it).
#define MASKED_BN_LAUNCH(kernel, f, vec, chunks, stream, ...)                          \
  do {                                                                                 \
    if (((vec) != 1 && (vec) != 2 && (vec) != 4) || (f) % (vec) != 0)                 \
      return static_cast<int>(cudaErrorInvalidValue);                                  \
    const dim3 grid = chunk_grid((f), (vec), (chunks));                                \
    auto st = static_cast<cudaStream_t>(stream);                                       \
    if ((vec) == 4) kernel<4><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                 \
    else if ((vec) == 2) kernel<2><<<grid, kThreads, 0, st>>>(__VA_ARGS__);            \
    else kernel<1><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                            \
  } while (0)

}  // namespace

extern "C" {

// Every pointer is float32 but the masks (bool, one byte a row; null: every
// row). The caller checks shapes, devices and contiguity, allocates every
// output and scratch, and picks the path: the fused kernels for n <=
// egt_masked_bn_small_rows(), the partials and apply kernels above, with
// `chunks` chunks of `rows_per_chunk` rows (partials [chunks, F], counts
// [chunks]) and `vec` columns a thread (4, 2 or 1: F and every pointer
// aligned to it; the two kernels of a direction take the same). Each returns
// cudaGetLastError() after its launch (0 with nothing to do).

int egt_masked_bn_lanes() { return kLanes; }

int egt_masked_bn_small_rows() { return kSmallRows; }

int egt_masked_bn_fused(const void* x, const void* mask, const void* scale, const void* bias,
                        void* y, void* mean, void* rstd, void* running_mean,
                        void* running_var, int n, int f, float momentum, float keep_frac,
                        float eps, int relu, void* stream) {
  if (f == 0) return 0;
  if (n > kSmallRows) return static_cast<int>(cudaErrorInvalidValue);
  const Fwd p{static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
              static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<float*>(y), static_cast<float*>(mean), static_cast<float*>(rstd),
              static_cast<float*>(running_mean), static_cast<float*>(running_var),
              n, f, relu, momentum, keep_frac, eps};
  return launch_cluster(masked_bn_fused_kernel, p, n, f, stream);
}

int egt_masked_bn_grad_fused(const void* dy, const void* x, const void* mask, const void* mean,
                             const void* rstd, const void* scale, const void* bias, void* dx,
                             void* dscale, void* dbias, int n, int f, int relu, int frozen,
                             void* stream) {
  if (f == 0) return 0;
  if (n > kSmallRows) return static_cast<int>(cudaErrorInvalidValue);
  const Bwd q{static_cast<const float*>(dy), static_cast<const float*>(x),
              static_cast<const uint8_t*>(mask), static_cast<const float*>(mean),
              static_cast<const float*>(rstd), static_cast<const float*>(scale),
              static_cast<const float*>(bias), static_cast<float*>(dx),
              static_cast<float*>(dscale), static_cast<float*>(dbias), n, f, relu, frozen};
  return launch_cluster(masked_bn_grad_fused_kernel, q, n, f, stream);
}

int egt_masked_bn_partials(const void* x, const void* mask, void* pmean, void* pm2,
                           void* pcount, int n, int f, int vec, int chunks, int rows_per_chunk,
                           void* stream) {
  if (f == 0 || chunks == 0) return 0;
  Fwd p{};
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const uint8_t*>(mask);
  p.n = n;
  p.f = f;
  MASKED_BN_LAUNCH(masked_bn_partials_kernel, f, vec, chunks, stream, p,
                   static_cast<float*>(pmean), static_cast<float*>(pm2),
                   static_cast<float*>(pcount), rows_per_chunk);
  return last_error();
}

int egt_masked_bn_apply(const void* x, const void* pmean, const void* pm2, const void* pcount,
                        const void* scale, const void* bias, void* y, void* mean, void* rstd,
                        void* running_mean, void* running_var, int n, int f, int vec, int chunks,
                        int rows_per_chunk, float momentum, float keep_frac, float eps,
                        int relu, void* stream) {
  if (f == 0 || chunks == 0) return 0;
  const Fwd p{static_cast<const float*>(x), nullptr,
              static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<float*>(y), static_cast<float*>(mean), static_cast<float*>(rstd),
              static_cast<float*>(running_mean), static_cast<float*>(running_var),
              n, f, relu, momentum, keep_frac, eps};
  MASKED_BN_LAUNCH(masked_bn_apply_kernel, f, vec, chunks, stream, p,
                   static_cast<const float*>(pmean), static_cast<const float*>(pm2),
                   static_cast<const float*>(pcount), chunks, rows_per_chunk);
  return last_error();
}

int egt_masked_bn_grad_partials(const void* dy, const void* x, const void* mask,
                                const void* mean, const void* rstd, const void* scale,
                                const void* bias, void* pdz, void* pdzx, void* pcount, int n,
                                int f, int vec, int chunks, int rows_per_chunk, int relu,
                                int frozen, void* stream) {
  if (f == 0 || chunks == 0) return 0;
  const Bwd q{static_cast<const float*>(dy), static_cast<const float*>(x),
              static_cast<const uint8_t*>(mask), static_cast<const float*>(mean),
              static_cast<const float*>(rstd), static_cast<const float*>(scale),
              static_cast<const float*>(bias), nullptr, nullptr, nullptr, n, f, relu, frozen};
  MASKED_BN_LAUNCH(masked_bn_grad_partials_kernel, f, vec, chunks, stream, q,
                   static_cast<float*>(pdz), static_cast<float*>(pdzx),
                   static_cast<float*>(pcount), rows_per_chunk);
  return last_error();
}

int egt_masked_bn_grad_apply(const void* dy, const void* x, const void* mask, const void* mean,
                             const void* rstd, const void* scale, const void* bias,
                             const void* pdz, const void* pdzx, const void* pcount, void* dx,
                             void* dscale, void* dbias, int n, int f, int vec, int chunks,
                             int rows_per_chunk, int relu, int frozen, void* stream) {
  if (f == 0 || chunks == 0) return 0;
  const Bwd q{static_cast<const float*>(dy), static_cast<const float*>(x),
              static_cast<const uint8_t*>(mask), static_cast<const float*>(mean),
              static_cast<const float*>(rstd), static_cast<const float*>(scale),
              static_cast<const float*>(bias), static_cast<float*>(dx),
              static_cast<float*>(dscale), static_cast<float*>(dbias), n, f, relu, frozen};
  MASKED_BN_LAUNCH(masked_bn_grad_apply_kernel, f, vec, chunks, stream, q,
                   static_cast<const float*>(pdz), static_cast<const float*>(pdzx),
                   static_cast<const float*>(pcount), chunks, rows_per_chunk);
  return last_error();
}

int egt_masked_bn_eval(const void* x, const void* scale, const void* bias,
                       const void* running_mean, const void* running_var, void* y, void* mean,
                       void* rstd, int n, int f, int vec, int chunks, int rows_per_chunk,
                       float eps, int relu, void* stream) {
  if (f == 0 || chunks == 0) return 0;
  Fwd p{};
  p.x = static_cast<const float*>(x);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.mean = static_cast<float*>(mean);
  p.rstd = static_cast<float*>(rstd);
  p.running_mean = const_cast<float*>(static_cast<const float*>(running_mean));
  p.running_var = const_cast<float*>(static_cast<const float*>(running_var));
  p.n = n;
  p.f = f;
  p.relu = relu;
  p.eps = eps;
  MASKED_BN_LAUNCH(masked_bn_eval_kernel, f, vec, chunks, stream, p, rows_per_chunk);
  return last_error();
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
