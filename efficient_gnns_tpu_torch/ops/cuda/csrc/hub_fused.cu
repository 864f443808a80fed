// The elementwise passes of the hub attention layer around K1, fused: two
// kernels in the forward and two in the backward.
//
//   forward    y     = [z * x | z] in the z-fold layout      (message kernel)
//              total = A_w @ y                                (K1, unchanged)
//              out   = num / den * s + res                    (epilogue kernel)
//   backward   ct    = [g*s/den | -sum_d(g*s*num/den)/den]    (cotangent kernel)
//              dy    = A_w^T @ ct                             (K1, unchanged)
//              dx    = dy * z,  dz = sum_d dy * x + dy[z col] (message-grad kernel)
//
// Replaces no TPU kernel: these are the XLA elementwise chain of
// efficient_gnns_tpu/ops/hub_attention.py::hub_gat_attention (the z-fold
// concatenation, the cast of the messages, _normalize and its backward) and
// of the DGL GAT layer's symmetric-norm and residual epilogue, which PyTorch
// runs as six to ten separate broadcast, strided and concatenating passes
// over [N, H*dp] float32 tensors.
//
// Bound: device-memory bytes. Each kernel does a few flops per element and
// touches each input and output element once: at the teacher's hidden layers
// (N = 169,343, H = 3, D = 250, dp = 256, bfloat16 messages) the message
// kernel moves 0.77 GB, the epilogue 1.54 GB, the cotangent kernel 1.29 GB
// and the message-grad kernel 1.54 GB, against about 6.4 GB forward and
// 12 GB backward for the chain they replace.
//
// Layout. y, total, ct and dy are [N, W], W = H*dp + hp: each head's block is
// dp = ceil(D / 128) * 128 columns; when D < dp the per-head scalar (z, den
// or its cotangent) sits in column D of the block and the rest of the block
// is zero (hp = 0); when D == dp it sits in a trailing block of hp =
// ceil(H / 128) * 128 columns, column H*dp + h. x, res, out, g and dx are
// [N, H, D]; z, dz are [N, H]; s is [N] or absent.
//
// Design: one warp owns one (node, head) pair, and its lanes stride the
// pair's columns, so every load and store of a warp covers consecutive
// addresses; a block holds kWarps pairs. Where a pass divides or reduces, a
// lane first loads kLoads of its columns and then computes on them, so that
// the loads of a row are in flight together (the IEEE division's branches
// otherwise keep the compiler from hoisting them). The two reductions over
// D are a butterfly of shuffles, which leaves the same bits in every lane. The
// arithmetic is the chain's own, rounded step by step with the _rn
// intrinsics so that nvcc's default FMA contraction cannot merge a product
// into a sum: the forward outputs are the bits that PyTorch's passes give,
// and the backward differs from them only in the order of the two sums over
// D. A denominator below the smallest normal float32 counts as an empty row:
// 0 out and 0 gradient. Every output element has one writer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                   // (node, head) pairs per block
constexpr int kLoads = 8;                   // columns a lane loads before it computes
constexpr float kTiny = 1.17549435e-38f;    // smallest normal float32

struct Layout {
  int n, heads, d, dp, hp;
  __device__ __forceinline__ long long width() const {
    return static_cast<long long>(heads) * dp + hp;
  }
  // column of the per-head scalar (z, den, their cotangents) within a row
  __device__ __forceinline__ long long scalar_col(int h) const {
    return hp ? static_cast<long long>(heads) * dp + h : static_cast<long long>(h) * dp + d;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The (node, head) pair of this warp, or -1 past the end.
__device__ __forceinline__ long long pair_index(const Layout& L) {
  const long long p = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  return p < static_cast<long long>(L.n) * L.heads ? p : -1;
}

template <typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
hub_message_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   OutT* __restrict__ y, Layout L) {
  const long long p = pair_index(L);
  if (p < 0) return;
  const int lane = threadIdx.x & 31;
  const long long row = p / L.heads;
  const int h = static_cast<int>(p - row * L.heads);
  const float zz = z[p];
  const float* xr = x + p * L.d;
  OutT* yr = y + row * L.width();
  OutT* block = yr + static_cast<long long>(h) * L.dp;
#pragma unroll 4
  for (int j = lane; j < L.dp; j += 32) {
    const float v = j < L.d ? __fmul_rn(xr[j], zz) : (j == L.d ? zz : 0.0f);
    block[j] = from_float<OutT>(v);
  }
  if (L.hp && h == 0) {  // the trailing block: z of every head, then zeros
    OutT* tail = yr + static_cast<long long>(L.heads) * L.dp;
    for (int i = lane; i < L.hp; i += 32)
      tail[i] = from_float<OutT>(i < L.heads ? z[row * L.heads + i] : 0.0f);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
hub_epilogue_kernel(const float* __restrict__ total, const float* __restrict__ scale,
                    const float* __restrict__ res, float* __restrict__ out, Layout L) {
  const long long p = pair_index(L);
  if (p < 0) return;
  const int lane = threadIdx.x & 31;
  const long long row = p / L.heads;
  const int h = static_cast<int>(p - row * L.heads);
  const float* tr = total + row * L.width();
  float den = tr[L.scalar_col(h)];
  den = den >= kTiny ? den : __int_as_float(0x7f800000);  // an empty row: num / inf = 0
  const float s = scale ? scale[row] : 1.0f;
  const float* num = tr + static_cast<long long>(h) * L.dp;
  const float* rr = res ? res + p * L.d : nullptr;
  float* o = out + p * L.d;
  for (int base = lane; base < L.d; base += 32 * kLoads) {
    float nv[kLoads], rv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + 32 * u;
      nv[u] = j < L.d ? num[j] : 0.0f;
      rv[u] = res && j < L.d ? rr[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + 32 * u;
      if (j >= L.d) break;
      float v = __fdiv_rn(nv[u], den);
      if (scale) v = __fmul_rn(v, s);
      if (res) v = __fadd_rn(v, rv[u]);
      o[j] = v;
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
hub_cotangent_kernel(const float* __restrict__ g, const float* __restrict__ total,
                     const float* __restrict__ scale, OutT* __restrict__ ct, Layout L) {
  const long long p = pair_index(L);
  if (p < 0) return;
  const int lane = threadIdx.x & 31;
  const long long row = p / L.heads;
  const int h = static_cast<int>(p - row * L.heads);
  const float* tr = total + row * L.width();
  const float den = tr[L.scalar_col(h)];
  const bool pos = den >= kTiny;
  const float inv = pos ? __fdiv_rn(1.0f, den) : 0.0f;
  const float den_out = pos ? den : __int_as_float(0x7f800000);
  const float s = scale ? scale[row] : 1.0f;
  const float* num = tr + static_cast<long long>(h) * L.dp;
  const float* gr = g + p * L.d;
  OutT* cr = ct + row * L.width();
  OutT* block = cr + static_cast<long long>(h) * L.dp;
  float acc = 0.0f;
  for (int base = lane; base < L.dp; base += 32 * kLoads) {
    float gv[kLoads], nv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + 32 * u;
      gv[u] = j < L.d ? gr[j] : 0.0f;
      nv[u] = j < L.d ? num[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + 32 * u;
      if (j >= L.dp) break;
      float v = 0.0f;
      if (j < L.d) {
        float gg = gv[u];
        if (scale) gg = __fmul_rn(gg, s);
        acc = __fadd_rn(acc, __fmul_rn(gg, __fdiv_rn(nv[u], den_out)));
        v = __fmul_rn(gg, inv);
      }
      block[j] = from_float<OutT>(v);  // column D (z-fold) is written again below
    }
  }
  acc = warp_sum(acc);
  const OutT dden = from_float<OutT>(__fmul_rn(-acc, inv));
  if (!L.hp) {
    if (lane == (L.d & 31)) block[L.d] = dden;  // the lane that zeroed column D
  } else {
    if (lane == 0) cr[L.scalar_col(h)] = dden;
    if (h == 0) {  // the trailing block's padding
      OutT* tail = cr + static_cast<long long>(L.heads) * L.dp;
      for (int i = L.heads + lane; i < L.hp; i += 32) tail[i] = from_float<OutT>(0.0f);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
hub_message_grad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                        const float* __restrict__ z, float* __restrict__ dx,
                        float* __restrict__ dz, Layout L) {
  const long long p = pair_index(L);
  if (p < 0) return;
  const int lane = threadIdx.x & 31;
  const long long row = p / L.heads;
  const int h = static_cast<int>(p - row * L.heads);
  const float zz = z[p];
  const float* dyr = dy + row * L.width();
  const float* block = dyr + static_cast<long long>(h) * L.dp;
  const float* xr = x + p * L.d;
  float* dxr = dx + p * L.d;
  float acc = 0.0f;
  for (int base = lane; base < L.d; base += 32 * kLoads) {
    float gv[kLoads], xv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + 32 * u;
      gv[u] = j < L.d ? block[j] : 0.0f;
      xv[u] = j < L.d ? xr[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + 32 * u;
      if (j >= L.d) break;
      dxr[j] = __fmul_rn(gv[u], zz);
      acc = __fadd_rn(acc, __fmul_rn(gv[u], xv[u]));
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) dz[p] = __fadd_rn(acc, dyr[L.scalar_col(h)]);
}

inline unsigned grid_for(const Layout& L) {
  const long long pairs = static_cast<long long>(L.n) * L.heads;
  return static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Every pointer is float32 unless a dtype code says otherwise (0 = float32,
// 1 = bfloat16); scale and res may be null. The caller checks shapes,
// devices and contiguity. Each returns cudaGetLastError() after its launch
// (0 with nothing to do).

int egt_hub_messages(const void* x, const void* z, void* y, int y_dtype, int n, int heads,
                     int d, int dp, int hp, void* stream) {
  const Layout L{n, heads, d, dp, hp};
  if (grid_for(L) == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* zf = static_cast<const float*>(z);
  if (y_dtype == 0)
    hub_message_kernel<float><<<grid_for(L), kWarps * 32, 0, st>>>(
        xf, zf, static_cast<float*>(y), L);
  else if (y_dtype == 1)
    hub_message_kernel<__nv_bfloat16><<<grid_for(L), kWarps * 32, 0, st>>>(
        xf, zf, static_cast<__nv_bfloat16*>(y), L);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return last_error();
}

int egt_hub_epilogue(const void* total, const void* scale, const void* res, void* out, int n,
                     int heads, int d, int dp, int hp, void* stream) {
  const Layout L{n, heads, d, dp, hp};
  if (grid_for(L) == 0) return 0;
  hub_epilogue_kernel<<<grid_for(L), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(total), static_cast<const float*>(scale),
      static_cast<const float*>(res), static_cast<float*>(out), L);
  return last_error();
}

int egt_hub_cotangent(const void* g, const void* total, const void* scale, void* ct,
                      int ct_dtype, int n, int heads, int d, int dp, int hp, void* stream) {
  const Layout L{n, heads, d, dp, hp};
  if (grid_for(L) == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* tf = static_cast<const float*>(total);
  const auto* sf = static_cast<const float*>(scale);
  if (ct_dtype == 0)
    hub_cotangent_kernel<float><<<grid_for(L), kWarps * 32, 0, st>>>(
        gf, tf, sf, static_cast<float*>(ct), L);
  else if (ct_dtype == 1)
    hub_cotangent_kernel<__nv_bfloat16><<<grid_for(L), kWarps * 32, 0, st>>>(
        gf, tf, sf, static_cast<__nv_bfloat16*>(ct), L);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return last_error();
}

int egt_hub_message_grad(const void* dy, const void* x, const void* z, void* dx, void* dz,
                         int n, int heads, int d, int dp, int hp, void* stream) {
  const Layout L{n, heads, d, dp, hp};
  if (grid_for(L) == 0) return 0;
  hub_message_grad_kernel<<<grid_for(L), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(x),
      static_cast<const float*>(z), static_cast<float*>(dx), static_cast<float*>(dz), L);
  return last_error();
}

const char* egt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
