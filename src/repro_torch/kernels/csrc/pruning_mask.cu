// Hopper (sm_90a) kernels for the pruned-FedSGD round over the packed
// [R, 128] fp32 parameter buffer (repro_torch/core/packing.py).
//
// Each kernel replaces one Pallas TPU kernel of
// src/repro/kernels/pruning_mask.py and has a plain PyTorch version beside
// its Python wrapper (repro_torch/kernels/pruning_mask.py) that it must
// match bit for bit.
//
// All seven are elementwise, histogram or per-coordinate sort passes over
// a few MiB: they are bound by device-memory bytes, and at the packed sizes
// of the paper's models (R = 1024, 512 KiB a buffer) by the launch itself.
// The design reads every input once (16-byte float4 / int4 loads where a
// thread owns 4 coordinates), writes every output once, and uses a
// grid-stride loop so one launch covers any R.
//
// Numerics, stated explicitly rather than left to compiler flags:
//   * every product, sum and difference uses __fmul_rn / __fadd_rn /
//     __fsub_rn, so nvcc can never contract `acc + cw*g` or `w - eta*g`
//     into an FMA (the reference rounds each op on its own);
//   * denormals are zero where the JAX reference (XLA:CPU, TPU) flushes
//     them: the importance q = (w*v)^2 and the threshold it is compared
//     with. daz(x) = |x| < FLT_MIN ? +0 : x.
// The library is built without --use_fast_math and without -ftz.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

__device__ __forceinline__ float daz(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

// q = (w*v)^2, each product rounded, flushed to +0 below FLT_MIN.
__device__ __forceinline__ float importance(float w, float v) {
  const float p = __fmul_rn(w, v);
  return daz(__fmul_rn(p, p));
}

__device__ __forceinline__ float keep(float prunable, float q, float thr) {
  return prunable > 0.0f ? (q >= thr ? 1.0f : 0.0f) : 1.0f;
}

int grid_for(long long n4) {
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// Replaces pruning_mask.importance_mask_batched (and, with n_clients = 1,
// importance_mask_2d plus ops.packed_importance_mask's prunable override).
// One thread reads 4 coordinates of (w, v, prunable) once, writes q once
// and then the n_clients masks; the thresholds are read from device memory
// (they come out of the on-device threshold search, never the host).
__global__ void importance_masks_kernel(
    const float4* __restrict__ w, const float4* __restrict__ v,
    const float4* __restrict__ prunable, const float* __restrict__ thr,
    int n_clients, long long n4, float4* __restrict__ q,
    float4* __restrict__ masks) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 a = w[i];
    const float4 b = v[i];
    const float4 p = prunable[i];
    float4 qq;
    qq.x = importance(a.x, b.x);
    qq.y = importance(a.y, b.y);
    qq.z = importance(a.z, b.z);
    qq.w = importance(a.w, b.w);
    q[i] = qq;
    for (int c = 0; c < n_clients; ++c) {
      const float t = daz(thr[c]);
      float4 m;
      m.x = keep(p.x, qq.x, t);
      m.y = keep(p.y, qq.y, t);
      m.z = keep(p.z, qq.z, t);
      m.w = keep(p.w, qq.w, t);
      masks[static_cast<long long>(c) * n4 + i] = m;
    }
  }
}

// Replaces pruning_mask.fedsgd_aggregate_weighted. The client loop runs in
// stack order, like the reference's sum; a client whose weight is not > 0
// is skipped without reading its gradient, so a NaN on a padding or
// quarantined client never reaches the sum. inv and eta are device scalars
// (inv comes out of the on-device quarantine: no host sync per round).
__global__ void fedsgd_aggregate_weighted_kernel(
    const float4* __restrict__ w, const float4* __restrict__ grads,
    const float* __restrict__ cw, int n_clients,
    const float* __restrict__ inv_ptr, const float* __restrict__ eta_ptr,
    long long n4, float4* __restrict__ w_out, float4* __restrict__ g_out,
    float4* __restrict__ step_out) {
  const float inv = *inv_ptr;
  const float eta = *eta_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < n_clients; ++c) {
      const float wc = cw[c];
      if (wc > 0.0f) {
        const float4 g = grads[static_cast<long long>(c) * n4 + i];
        acc.x = __fadd_rn(acc.x, __fmul_rn(wc, g.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(wc, g.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(wc, g.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(wc, g.w));
      }
    }
    float4 g;
    g.x = __fmul_rn(acc.x, inv);
    g.y = __fmul_rn(acc.y, inv);
    g.z = __fmul_rn(acc.z, inv);
    g.w = __fmul_rn(acc.w, inv);
    float4 st;
    st.x = __fmul_rn(eta, g.x);
    st.y = __fmul_rn(eta, g.y);
    st.z = __fmul_rn(eta, g.z);
    st.w = __fmul_rn(eta, g.w);
    const float4 ww = w[i];
    float4 wo;
    wo.x = __fsub_rn(ww.x, st.x);
    wo.y = __fsub_rn(ww.y, st.y);
    wo.z = __fsub_rn(ww.z, st.z);
    wo.w = __fsub_rn(ww.w, st.w);
    g_out[i] = g;
    step_out[i] = st;
    w_out[i] = wo;
  }
}

__device__ __forceinline__ void count_byte(int* bins, int bits, float p) {
  const int b = bits >> 23;
  if (p > 0.0f && b >= 0 && b < 256) atomicAdd(&bins[b], 1);
}

// Replaces pruning_mask.exponent_histogram. Blocks run in no order on the
// card, so instead of the TPU's running total over sequential grid steps
// each block counts into 256 shared-memory bins and then adds each nonzero
// bin into the global [256] int32 histogram once. Integer atomics make the
// counts exact in any order. Bytes outside [0, 255] (a set sign bit) are
// dropped, as the Pallas compare-reduce drops them.
__global__ void exponent_histogram_kernel(const int4* __restrict__ qbits,
                                          const float4* __restrict__ prunable,
                                          long long n4, int* __restrict__ hist) {
  __shared__ int bins[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const int4 qb = qbits[i];
    const float4 p = prunable[i];
    count_byte(bins, qb.x, p.x);
    count_byte(bins, qb.y, p.y);
    count_byte(bins, qb.z, p.z);
    count_byte(bins, qb.w, p.w);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    if (bins[b]) atomicAdd(&hist[b], bins[b]);
  }
}

// Replaces pruning_mask.fedsgd_aggregate: the unweighted eqs. (6)-(7),
// reached through ops.packed_fedsgd_update. The sum runs in client-stack
// order from the first client's gradient (acc = g[0]; acc = acc + g[c]),
// then g = acc * inv with inv = float32(1/C) from the host, step = eta*g
// and w' = w - step, each op rounded on its own: the sequence the xla
// mirror writes and the weighted kernel computes. (XLA:CPU reassociates the
// mirror's step into (eta * inv) * acc, the same bits only when 1/C is a
// power of two; the port keeps the written order.) Bound by bytes: reads w
// and C gradients, writes 3 buffers.
__global__ void fedsgd_aggregate_kernel(
    const float4* __restrict__ w, const float4* __restrict__ grads,
    int n_clients, float inv, float eta, long long n4,
    float4* __restrict__ w_out, float4* __restrict__ g_out,
    float4* __restrict__ step_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 acc = grads[i];
    for (int c = 1; c < n_clients; ++c) {
      const float4 g = grads[static_cast<long long>(c) * n4 + i];
      acc.x = __fadd_rn(acc.x, g.x);
      acc.y = __fadd_rn(acc.y, g.y);
      acc.z = __fadd_rn(acc.z, g.z);
      acc.w = __fadd_rn(acc.w, g.w);
    }
    float4 g;
    g.x = __fmul_rn(acc.x, inv);
    g.y = __fmul_rn(acc.y, inv);
    g.z = __fmul_rn(acc.z, inv);
    g.w = __fmul_rn(acc.w, inv);
    float4 st;
    st.x = __fmul_rn(eta, g.x);
    st.y = __fmul_rn(eta, g.y);
    st.z = __fmul_rn(eta, g.z);
    st.w = __fmul_rn(eta, g.w);
    const float4 ww = w[i];
    float4 wo;
    wo.x = __fsub_rn(ww.x, st.x);
    wo.y = __fsub_rn(ww.y, st.y);
    wo.z = __fsub_rn(ww.z, st.z);
    wo.w = __fsub_rn(ww.w, st.w);
    g_out[i] = g;
    step_out[i] = st;
    w_out[i] = wo;
  }
}

// Replaces pruning_mask.masked_update_2d: (w - eta*g) * mask, each op
// rounded on its own (__fmul_rn / __fsub_rn), as the eager
// ref.masked_update_ref computes it. Bound by bytes: 3 reads, 1 write.
__global__ void masked_update_kernel(const float4* __restrict__ w,
                                     const float4* __restrict__ g,
                                     const float4* __restrict__ m, float eta,
                                     long long n4, float4* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 a = w[i];
    const float4 b = g[i];
    const float4 k = m[i];
    float4 o;
    o.x = __fmul_rn(__fsub_rn(a.x, __fmul_rn(eta, b.x)), k.x);
    o.y = __fmul_rn(__fsub_rn(a.y, __fmul_rn(eta, b.y)), k.y);
    o.z = __fmul_rn(__fsub_rn(a.z, __fmul_rn(eta, b.z)), k.z);
    o.w = __fmul_rn(__fsub_rn(a.w, __fmul_rn(eta, b.w)), k.w);
    out[i] = o;
  }
}

// Monotone int32 total-order key of an fp32 bit pattern: b ^ ((b >> 31) &
// 0x7fffffff) compares like the float values, -0.0 strictly below +0.0.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Up to this many clients the sort network lives in registers.
constexpr int kMaxRegisterClients = 32;

// Replaces pruning_mask.client_rank_sort, the first stage of the
// coordinate-wise median and the trimmed mean. One thread owns one
// coordinate of the [C, n] stack: it reads the coordinate's C values (row
// c of neighbouring threads is one contiguous segment, so every read is
// coalesced), keys them (zero-weight clients get the INT_MAX sentinel and
// sort last), runs the odd-even transposition network of the TPU kernel
// fully unrolled in registers (C is a template parameter), and writes the C
// ranks. The network swaps only on a strict key > key, so it is stable:
// equal keys (the sentinel lanes included) keep their input order, and the
// output is bitwise a stable sort's on every rank. Bound by bytes: one read
// and one write of the stack, 2*C*n*4.
template <int C>
__global__ void client_rank_sort_kernel(const float* __restrict__ grads,
                                        const float* __restrict__ cw,
                                        long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    int key[C];
    float val[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v = grads[static_cast<long long>(c) * n + i];
      val[c] = v;
      key[c] = __ldg(&cw[c]) > 0.0f ? order_key(v) : INT_MAX;
    }
#pragma unroll
    for (int p = 0; p < C; ++p) {
#pragma unroll
      for (int j = p & 1; j < C - 1; j += 2) {
        const bool swap = key[j] > key[j + 1];
        const int ka = key[j], kb = key[j + 1];
        const float va = val[j], vb = val[j + 1];
        key[j] = swap ? kb : ka;
        key[j + 1] = swap ? ka : kb;
        val[j] = swap ? vb : va;
        val[j + 1] = swap ? va : vb;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[static_cast<long long>(c) * n + i] = val[c];
    }
  }
}

// The same network for C > kMaxRegisterClients, where the ranks no longer
// fit in registers: each thread sorts its coordinate's column in place in
// the output, with the keys in an int32 scratch stack of the same shape
// (both coalesced across threads, as above).
__global__ void client_rank_sort_generic_kernel(
    const float* __restrict__ grads, const float* __restrict__ cw,
    int n_clients, long long n, float* __restrict__ out,
    int* __restrict__ keys) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    for (int c = 0; c < n_clients; ++c) {
      const long long at = static_cast<long long>(c) * n + i;
      const float v = grads[at];
      out[at] = v;
      keys[at] = cw[c] > 0.0f ? order_key(v) : INT_MAX;
    }
    for (int p = 0; p < n_clients; ++p) {
      for (int j = p & 1; j < n_clients - 1; j += 2) {
        const long long a = static_cast<long long>(j) * n + i;
        const long long b = a + n;
        const int ka = keys[a], kb = keys[b];
        if (ka > kb) {
          const float va = out[a];
          keys[a] = kb;
          keys[b] = ka;
          out[a] = out[b];
          out[b] = va;
        }
      }
    }
  }
}

template <int C>
int launch_rank_sort(int n_clients, const float* grads, const float* cw,
                     long long n, float* out, int* keys,
                     cudaStream_t stream) {
  if (n_clients == C) {
    client_rank_sort_kernel<C><<<grid_for(n), kThreads, 0, stream>>>(
        grads, cw, n, out);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (C < kMaxRegisterClients) {
    return launch_rank_sort<C + 1>(n_clients, grads, cw, n, out, keys,
                                   stream);
  } else {
    client_rank_sort_generic_kernel<<<grid_for(n), kThreads, 0, stream>>>(
        grads, cw, n_clients, n, out, keys);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. n is the element count of one
// [R, 128] buffer (a multiple of 4); every pointer is contiguous and, where
// a kernel reads float4, 16-byte aligned (the wrappers check). Each returns
// cudaGetLastError().
extern "C" {

int importance_masks(const void* w, const void* v, const void* prunable,
                     const void* thr, int n_clients, long long n, void* q,
                     void* masks, void* stream) {
  const long long n4 = n / 4;
  importance_masks_kernel<<<grid_for(n4), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<const float4*>(v),
      static_cast<const float4*>(prunable), static_cast<const float*>(thr),
      n_clients, n4, static_cast<float4*>(q), static_cast<float4*>(masks));
  return static_cast<int>(cudaGetLastError());
}

int fedsgd_aggregate_weighted(const void* w, const void* grads, const void* cw,
                              int n_clients, const void* inv, const void* eta,
                              long long n, void* w_out, void* g_out,
                              void* step_out, void* stream) {
  const long long n4 = n / 4;
  fedsgd_aggregate_weighted_kernel<<<grid_for(n4), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<const float4*>(grads),
      static_cast<const float*>(cw), n_clients,
      static_cast<const float*>(inv), static_cast<const float*>(eta), n4,
      static_cast<float4*>(w_out), static_cast<float4*>(g_out),
      static_cast<float4*>(step_out));
  return static_cast<int>(cudaGetLastError());
}

int exponent_histogram(const void* q, const void* prunable, long long n,
                       void* hist, void* stream) {
  const long long n4 = n / 4;
  exponent_histogram_kernel<<<grid_for(n4), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(q), static_cast<const float4*>(prunable), n4,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

int fedsgd_aggregate(const void* w, const void* grads, int n_clients,
                     float inv, float eta, long long n, void* w_out,
                     void* g_out, void* step_out, void* stream) {
  const long long n4 = n / 4;
  fedsgd_aggregate_kernel<<<grid_for(n4), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<const float4*>(grads),
      n_clients, inv, eta, n4, static_cast<float4*>(w_out),
      static_cast<float4*>(g_out), static_cast<float4*>(step_out));
  return static_cast<int>(cudaGetLastError());
}

int masked_update(const void* w, const void* g, const void* mask, float eta,
                  long long n, void* out, void* stream) {
  const long long n4 = n / 4;
  masked_update_kernel<<<grid_for(n4), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<const float4*>(g),
      static_cast<const float4*>(mask), eta, n4, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// keys: int32 scratch of the stack's shape, used (and required) only for
// n_clients > kMaxRegisterClients.
int client_rank_sort(const void* grads, const void* cw, int n_clients,
                     long long n, void* out, void* keys, void* stream) {
  return launch_rank_sort<1>(n_clients, static_cast<const float*>(grads),
                             static_cast<const float*>(cw), n,
                             static_cast<float*>(out),
                             static_cast<int*>(keys),
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
