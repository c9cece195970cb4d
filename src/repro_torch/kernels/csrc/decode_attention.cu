// Flash-decoding for Hopper (sm_90a): one query token of every query head
// against a KV cache, keys at or past `pos` masked, fp32 online softmax,
// fp32 or bf16 storage.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention`, pallas_call at :82). The JAX wrapper transposes the
// whole cache to [B*Hkv, Skv, D] on every call (decode_attention.py:76-77);
// here the cache is read in place, in its serving layout [B, Skv, Hkv, D],
// by strides. The TPU kernel skips the kv blocks at or past `pos`; this
// one reads exactly the keys below pos[b] (a per-row count, so the rows of
// a continuous batch can sit at different positions). At pos = 0 no key is
// read and the output is 0 (acc / max(l, 1e-20) with l = 0), the TPU
// kernel's result.
//
// Bound: bytes. Every live key row of K and V is read once (4 * D bytes a
// key and kv head in bf16) for 4 * D * (Hq / Hkv) FLOPs, far below the
// card's ridge. Design: one block per (kv head, batch row) computes all
// G = Hq / Hkv query heads of that kv head, so each cache row is read
// once, not G times. A key row is split over D / 8 lanes, each loading 16
// contiguous bytes (8 bf16), so a warp reads 32 / (D / 8) whole rows per
// instruction; each such lane group is an independent online-softmax
// worker that strides over the keys, U keys in flight, and the 4 warps'
// workers are merged through shared memory at the end. No split over the
// key axis across blocks yet (later work).

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;  // [B] valid cache lengths
  void* o;
  int skv;
  long long qs[2];  // q strides of (b, h)
  long long ks[3];  // cache strides of (b, s, h)
  long long vs[3];
  long long os[2];  // out strides of (b, h)
  float scale;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const DecodeArgs a) {
  constexpr int LPK = D / 8;         // lanes per key row
  constexpr int NG = 32 / LPK;       // key workers per warp
  constexpr int NW = (kThreads / 32) * NG;
  constexpr int U = G <= 4 ? 4 : 2;  // keys in flight per worker
  __shared__ float s_m[NW][G], s_l[NW][G];
  __shared__ float s_acc[NW][G][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, grp = lane / LPK, worker = warp * NG + grp;
  const int d0 = sub * 8;
  const int n = min(max(a.pos[b], 0), a.skv);

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];

  float qr[G][8], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(qb + (hk * G + g) * a.qs[1] + d0, qr[g]);
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
  }

  // the trip count is the warp's (not the worker's): every lane reaches
  // the shuffles below, whose mask is the whole warp
  for (int wbase = warp * NG; wbase < n; wbase += U * NW) {
    const int base = wbase + grp;
    float kk[U][8], vv[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * NW;
      if (key < n) {
        load8(kb + key * a.ks[1] + d0, kk[u]);
        load8(vb + key * a.vs[1] + d0, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kk[u][e] = vv[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) t = fmaf(qr[g][e], kk[u][e], t);
        s[g] = t;
      }
      // every lane takes part in the shuffles; the update is per key
#pragma unroll
      for (int off = LPK / 2; off; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] += __shfl_xor_sync(kFullMask, s[g], off);
      if (base + u * NW < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float x = s[g] * a.scale;
          const float m_new = fmaxf(m[g], x);
          const float corr = expf(m[g] - m_new), p = expf(x - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][e] = fmaf(p, vv[u][e], acc[g][e] * corr);
          m[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s_acc[worker][g][d0 + e] = acc[g][e];
    if (sub == 0) {
      s_m[worker][g] = m[g];
      s_l[worker][g] = l[g];
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.o) + b * a.os[0];
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.0f, osum = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(s_m[w][g] - mx);
      lsum += s_l[w][g] * f;
      osum += s_acc[w][g][d] * f;
    }
    ob[(hk * G + g) * a.os[1] + d] = from_f<T>(osum / fmaxf(lsum, 1e-20f));
  }
}

template <typename T, int D, int G>
int launch(const DecodeArgs& a, int batch, int hkv, cudaStream_t stream) {
  decode_attention_kernel<T, D, G>
      <<<dim3(hkv, batch), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const DecodeArgs& a, int batch, int hkv, int g,
             cudaStream_t stream) {
  switch (g) {
    case 1: return launch<T, D, 1>(a, batch, hkv, stream);
    case 2: return launch<T, D, 2>(a, batch, hkv, stream);
    case 4: return launch<T, D, 4>(a, batch, hkv, stream);
    case 8: return launch<T, D, 8>(a, batch, hkv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_d(const DecodeArgs& a, int batch, int hkv, int g, int d,
             cudaStream_t stream) {
  switch (d) {
    case 64: return launch_g<T, 64>(a, batch, hkv, g, stream);
    case 128: return launch_g<T, 128>(a, batch, hkv, g, stream);
    case 256: return launch_g<T, 256>(a, batch, hkv, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dims: b, hq, hkv, skv, d; strides: q (b, h), k (b, s, h), v (b, s, h),
// o (b, h); pos: device int32 [b].
int decode_attention(const void* q, const void* k, const void* v,
                     const void* pos, void* o, const long long* dims,
                     const long long* strides, int is_bf16, float scale,
                     void* stream) {
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.pos = static_cast<const int*>(pos);
  a.skv = static_cast<int>(dims[3]);
  a.qs[0] = strides[0]; a.qs[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    a.ks[i] = strides[2 + i];
    a.vs[i] = strides[5 + i];
  }
  a.os[0] = strides[8]; a.os[1] = strides[9];
  a.scale = scale;
  const int batch = static_cast<int>(dims[0]), hkv = static_cast<int>(dims[2]);
  const int g = static_cast<int>(dims[1] / dims[2]), d = static_cast<int>(dims[4]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(a, batch, hkv, g, d, s)
                 : launch_d<float>(a, batch, hkv, g, d, s);
}

}  // extern "C"
