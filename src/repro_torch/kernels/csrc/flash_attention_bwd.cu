// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the forward
// in flash_attention.cu from (q, k, v, o, dO, lse), for GQA, a causal mask,
// a sliding window (kpos > qpos - window) and a softcap cap * tanh(s / cap);
// fp32 or bf16 storage, fp32 arithmetic.
//
// No Pallas kernel to replace: this is the port of the FlashAttention-2
// backward that the JAX package writes in jnp, `_bwd_scan` in
// src/repro/models/flash_vjp.py:93, the custom VJP of its training path,
// whose forward is kernel 8's function plus the row log-sum-exp (the
// forward kernels write lse when asked). Per (q, k) pair and query head:
//
//   s  = q.k scale, capped: sc = cap tanh(s / cap); masked: NEG_INF
//   p  = exp(sc - lse)                      (lse from the forward)
//   D  = rowsum(dO o)
//   dv += p dO ;  dp = dO.v ;  ds = p (dp - D) (1 - (sc / cap)^2 if capped)
//   dq += ds k scale ;  dk += ds q scale    (ds = 0 where masked)
//
// Three launches, no atomics, so a rerun gives the same bits:
//   1. `flash_bwd_delta_kernel`: D, one warp a row (fp32, [B, Hq, Sq]);
//   2. `flash_bwd_dkdv_kernel<T, D>`: one block per (key tile, kv head,
//      batch); it loops over the g query heads of its kv head and, for
//      each, over the query tiles that can see a key of its tile (the
//      causal / window band; tiles wholly outside are never loaded), so
//      GQA's sum over query heads is a register sum in a fixed order;
//   3. `flash_bwd_dq_kernel<T, D>`: one block per (query tile, query head,
//      batch), looping over the key tiles of its band.
// Both recompute s and p from the tiles (nothing of size S x S is stored).
//
// Bound: operations. The function needs 10 D FLOPs a live (q, k) pair and
// query head (s, dp, dv, dq, dk: 2 D each, FlashAttention-2's count); this
// kernel does 14 D (s and dp in both passes). Bytes are q, k, v, o, dO, lse
// once and dq, dk, dv once. For granite's train_4k layer (B 4, 32 / 8
// heads, D 64, 4096 tokens, causal) that is ~6.9e11 FLOPs against ~0.34
// GB: operations bound by far, at the tensor cores' rate (989 TFLOP/s
// bf16: 0.695 ms). This first kernel runs them on the
// CUDA cores in fp32 (FMAs from shared memory, 67 TFLOP/s at most), the
// simple and exact design; a wgmma / TMA redesign is queued (ROADMAP
// section 2) with the times this one reads in PERF.md.
//
// Tiles: 64 query rows; 64 / 32 / 16 keys at D 64 / 128 / 256, so that the
// dk and dv accumulators (keys x D each) are 64 fp32 registers a thread
// at every D. Tiles sit in shared memory as fp32 with rows padded by one
// word (a key per lane and a row per warp read different banks). Scoring
// maps lanes to keys and warps to rows: a thread holds 2 keys x 16 rows at
// D 64, 1 x 16 at D 128, 1 x 8 at D 256 (two half-warps on two row
// groups). Shared memory: 98 / 113 / 169 KB a block.
//
// Inputs are addressed by strides (elements; the last dim contiguous), so
// the model layout [B, S, H, D] is read and written in place; lse and D
// are [B, Hq, Sq] fp32 contiguous.

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr float kNegInf = -1073741824.0f;  // -2^30, as the forward
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;  // query rows a tile

template <int D>
__host__ __device__ constexpr int block_k() {
  return D == 64 ? 64 : (D == 128 ? 32 : 16);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, Hq, Sq]
  float* delta;      // [B, Hq, Sq], written by pass 1
  void* dq;
  void* dk;
  void* dv;
  int batch, hq, hkv, sq, skv;
  // strides (b, h, s) of q, k, v, o, dO, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], gs[3], dqs[3], dks[3], dvs[3];
  int causal, window;
  float cap, scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp) {
  return qp < a.sq && kp < a.skv && (!a.causal || kp <= qp) &&
         (!a.window || kp > qp - a.window);
}

// -- pass 1: D = rowsum(dO o) ------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const BwdArgs a, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.batch) * a.hq * a.sq) return;  // warp-uniform
  const int s = static_cast<int>(row % a.sq);
  const long long bh = row / a.sq;
  const int h = static_cast<int>(bh % a.hq), b = static_cast<int>(bh / a.hq);
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[1] +
               s * a.os[2];
  const T* g = static_cast<const T*>(a.dout) + b * a.gs[0] + h * a.gs[1] +
               s * a.gs[2];
  float acc = 0.0f;
  for (int i = lane; i < d; i += 32) acc = fmaf(to_f(o[i]), to_f(g[i]), acc);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[row] = acc;
}

// -- shared by passes 2 and 3 -------------------------------------------------

// rows [0, kBQ) of q and dO from row q0 into padded fp32 tiles, lse and D
// beside them (zeros past Sq)
template <typename T, int D>
__device__ __forceinline__ void load_rows(const BwdArgs& a, const T* qb,
                                          const T* gb, const float* lb,
                                          const float* db, int q0, float* sQ,
                                          float* sG, float* sL, float* sD) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D, s = q0 + r;
    const bool in = s < a.sq;
    sQ[r * P + c] = in ? to_f(qb[s * a.qs[2] + c]) : 0.0f;
    sG[r * P + c] = in ? to_f(gb[s * a.gs[2] + c]) : 0.0f;
  }
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < a.sq;
    sL[r] = in ? lb[q0 + r] : 0.0f;
    sD[r] = in ? db[q0 + r] : 0.0f;
  }
}

// keys [0, BK) of k and v from key k0 into padded fp32 tiles
template <typename T, int D, int BK>
__device__ __forceinline__ void load_keys(const BwdArgs& a, const T* kb,
                                          const T* vb, int k0, float* sK,
                                          float* sV) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int j = i / D, c = i - j * D, kp = k0 + j;
    const bool in = kp < a.skv;
    sK[j * P + c] = in ? to_f(kb[kp * a.ks[2] + c]) : 0.0f;
    sV[j * P + c] = in ? to_f(vb[kp * a.vs[2] + c]) : 0.0f;
  }
}

// p and ds of a (query tile q0, key tile k0) pair from the tiles in shared
// memory, into sP (when given) and sS, both [kBQ][BK]. A thread scores KT
// keys (lane % LK + LK t) of RT rows: lanes on keys, warps (and, at BK 16,
// half-warps) on rows.
template <int D, int BK>
__device__ __forceinline__ void score_tile(const BwdArgs& a, const float* sQ,
                                           const float* sG, const float* sK,
                                           const float* sV, const float* sL,
                                           const float* sD, float* sP,
                                           float* sS, int q0, int k0) {
  constexpr int P = D + 1;
  constexpr int LK = BK < 32 ? BK : 32;  // lanes on distinct keys
  constexpr int KT = BK / LK;            // keys a lane
  constexpr int RT = kBQ / (kWarps * (32 / LK));  // rows a thread
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * (kBQ / kWarps) + (lane / LK) * RT;
  const int key0 = lane % LK;
  float sc[RT][KT], dp[RT][KT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int t = 0; t < KT; ++t) sc[i][t] = dp[i][t] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < D; ++c) {
    float kv[KT], vv[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      kv[t] = sK[(key0 + LK * t) * P + c];
      vv[t] = sV[(key0 + LK * t) * P + c];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float qv = sQ[(row0 + i) * P + c], gv = sG[(row0 + i) * P + c];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        sc[i][t] = fmaf(qv, kv[t], sc[i][t]);
        dp[i][t] = fmaf(gv, vv[t], dp[i][t]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + i;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = key0 + LK * t;
      float s = sc[i][t] * a.scale;
      if (a.cap != 0.0f) s = a.cap * tanhf(s / a.cap);
      const bool ok = visible(a, q0 + r, k0 + j);
      const float p = ok ? expf(s - sL[r]) : 0.0f;
      float ds = p * (dp[i][t] - sD[r]);
      if (a.cap != 0.0f) {
        const float u = s / a.cap;
        ds *= 1.0f - u * u;
      }
      if (sP != nullptr) sP[r * BK + j] = p;
      sS[r * BK + j] = ok ? ds : 0.0f;
    }
  }
}

// -- pass 2: dk, dv -----------------------------------------------------------

template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int BK = block_k<D>();
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * BK * (D + 1) +
                          2 * kBQ * BK + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int BK = block_k<D>();
  constexpr int P = D + 1;
  constexpr int KW = BK / kWarps;  // keys a warp accumulates
  constexpr int DL = D / 32;       // dims a lane accumulates
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][P]
  float* sG = sQ + kBQ * P;      // dO [kBQ][P]
  float* sK = sG + kBQ * P;      // [BK][P]
  float* sV = sK + BK * P;       // [BK][P]
  float* sP = sV + BK * P;       // [kBQ][BK]
  float* sS = sP + kBQ * BK;     // ds [kBQ][BK]
  float* sL = sS + kBQ * BK;     // lse [kBQ]
  float* sD = sL + kBQ;          // D [kBQ]

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.hq / a.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  load_keys<T, D, BK>(a, kb, vb, k0, sK, sV);

  float dk[KW][DL], dv[KW][DL];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int e = 0; e < DL; ++e) dk[j][e] = dv[j][e] = 0.0f;

  // the query rows that see a key of this tile: from the tile's first key
  // under a causal mask, to its last key + window - 1 under a window
  const int k_last = min(k0 + BK, a.skv) - 1;
  const int q_begin = a.causal ? (k0 / kBQ) * kBQ : 0;
  const int q_end = a.window ? min(a.sq, k_last + a.window) : a.sq;

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const T* gb = static_cast<const T*>(a.dout) + b * a.gs[0] + h * a.gs[1];
    const long long row = (static_cast<long long>(b) * a.hq + h) * a.sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // every thread is done with the previous tile
      load_rows<T, D>(a, qb, gb, a.lse + row, a.delta + row, q0, sQ, sG, sL,
                      sD);
      __syncthreads();
      score_tile<D, BK>(a, sQ, sG, sK, sV, sL, sD, sP, sS, q0, k0);
      __syncthreads();
      // dv += p^T dO, dk += ds^T q over the tile's rows
      for (int r = 0; r < kBQ; ++r) {
        float gv[DL], qv[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          gv[e] = sG[r * P + lane + 32 * e];
          qv[e] = sQ[r * P + lane + 32 * e];
        }
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const float p = sP[r * BK + warp * KW + j];
          const float ds = sS[r * BK + warp * KW + j];
#pragma unroll
          for (int e = 0; e < DL; ++e) {
            dv[j][e] = fmaf(p, gv[e], dv[j][e]);
            dk[j][e] = fmaf(ds, qv[e], dk[j][e]);
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  T* dvb = static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int kp = k0 + warp * KW + j;
    if (kp < a.skv) {
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        dkb[kp * a.dks[2] + lane + 32 * e] = from_f<T>(dk[j][e] * a.scale);
        dvb[kp * a.dvs[2] + lane + 32 * e] = from_f<T>(dv[j][e]);
      }
    }
  }
}

// -- pass 3: dq ----------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BK = block_k<D>();
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * BK * (D + 1) + kBQ * BK +
                          2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int BK = block_k<D>();
  constexpr int P = D + 1;
  constexpr int RW = kBQ / kWarps;  // rows a warp accumulates
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][P]
  float* sG = sQ + kBQ * P;      // dO [kBQ][P]
  float* sK = sG + kBQ * P;      // [BK][P]
  float* sV = sK + BK * P;       // [BK][P]
  float* sS = sV + BK * P;       // ds [kBQ][BK]
  float* sL = sS + kBQ * BK;     // lse [kBQ]
  float* sD = sL + kBQ;          // D [kBQ]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* gb = static_cast<const T*>(a.dout) + b * a.gs[0] + h * a.gs[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const long long row = (static_cast<long long>(b) * a.hq + h) * a.sq;
  load_rows<T, D>(a, qb, gb, a.lse + row, a.delta + row, q0, sQ, sG, sL, sD);

  float dq[RW][DL];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int e = 0; e < DL; ++e) dq[i][e] = 0.0f;

  // the keys any row of this tile sees, as the forward's band
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  const int k_end = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int k_begin = a.window ? (max(0, q0 - a.window + 1) / BK) * BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    load_keys<T, D, BK>(a, kb, vb, k0, sK, sV);
    __syncthreads();
    score_tile<D, BK>(a, sQ, sG, sK, sV, sL, sD, nullptr, sS, q0, k0);
    __syncthreads();
    // dq += ds k over the tile's keys
    for (int j = 0; j < BK; ++j) {
      float kv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) kv[e] = sK[j * P + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float ds = sS[(warp * RW + i) * BK + j];
#pragma unroll
        for (int e = 0; e < DL; ++e) dq[i][e] = fmaf(ds, kv[e], dq[i][e]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int s = q0 + warp * RW + i;
    if (s < a.sq) {
#pragma unroll
      for (int e = 0; e < DL; ++e)
        dqb[s * a.dqs[2] + lane + 32 * e] = from_f<T>(dq[i][e] * a.scale);
    }
  }
}

template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr int BK = block_k<D>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D>,
                               dkdv_smem_bytes<D>(), dkdv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<T, D>, dq_smem_bytes<D>(), dq_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.batch) * a.hq * a.sq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) /
                                                    kWarps),
                              kThreads, 0, stream>>>(a, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.skv + BK - 1) / BK, a.hkv, a.batch);
  flash_bwd_dkdv_kernel<T, D>
      <<<grid_kv, kThreads, dkdv_smem_bytes<D>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.sq + kBQ - 1) / kBQ, a.hq, a.batch);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_smem_bytes<D>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const BwdArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dims: b, hq, hkv, sq, skv, d; strides: q, k, v, o, dO, dq, dk, dv as
// (b, h, s) each; lse and delta [B, Hq, Sq] fp32 (delta is scratch).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        const long long* dims, const long long* strides,
                        int is_bf16, int causal, int window, float cap,
                        float scale, void* stream) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.batch = static_cast<int>(dims[0]);
  a.hq = static_cast<int>(dims[1]);
  a.hkv = static_cast<int>(dims[2]);
  a.sq = static_cast<int>(dims[3]);
  a.skv = static_cast<int>(dims[4]);
  long long* dst[8] = {a.qs, a.ks, a.vs, a.os, a.gs, a.dqs, a.dks, a.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.causal = causal; a.window = window; a.cap = cap; a.scale = scale;
  const int d = static_cast<int>(dims[5]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(a, d, s) : launch_d<float>(a, d, s);
}

}  // extern "C"
