// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the forward
// in flash_attention.cu from (q, k, v, o, dO, lse), for GQA, a causal mask,
// a sliding window (kpos > qpos - window) and a softcap cap * tanh(s / cap);
// fp32 or bf16 storage, fp32 accumulation.
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
//   1. D = rowsum(dO o) into an fp32 [B, Hq, Sq] scratch;
//   2. dk, dv: one block per (key tile, kv head, batch), looping over the g
//      query heads of its kv head and, for each, over the query tiles that
//      can see a key of its tile (the causal / window band; tiles wholly
//      outside are never loaded), so GQA's sum over query heads is a
//      register sum in a fixed order;
//   3. dq: one block per (query tile, query head, batch), looping over the
//      key tiles of its band.
// Both recompute s and p from the tiles (nothing of size S x S is stored),
// so the kernels do 14 D FLOPs a live pair and query head against the
// function's 10 D (s and dp in both passes): the price of no atomics.
//
// Bound: operations. The function needs 10 D FLOPs a live (q, k) pair and
// query head (s, dp, dv, dq, dk: 2 D each, FlashAttention-2's count). Bytes
// are q, k, v, o, dO, lse once and dq, dk, dv once. For granite's train_4k
// layer (B 4, 32 / 8 heads, D 64, 4096 tokens, causal) that is ~6.9e11
// FLOPs against ~0.34 GB: operations bound by far, at the tensor cores'
// rate (989 TFLOP/s bf16: 0.695 ms).
//
// Kernels, picked by storage type and head dim (no switch, no fallback):
//
// * bf16 at D 64 and 128 (granite, qwen2.5-3b, yi-9b): the five products on
//   the tensor cores, `flash_bwd_dkdv_wgmma_kernel<D, warpgroups>` and
//   `flash_bwd_dq_wgmma_kernel<D, warpgroups>`, after
//   `flash_bwd_delta_bf16_kernel<D>` (16-byte loads, D / 8 lanes a row).
//   Every product is an m64n64k16 wgmma with fp32 accumulation (csrc/
//   wgmma.cuh), on 128-byte-swizzled bf16 tiles in shared memory that
//   cp.async fills (kernel 8's loader):
//   - dk, dv: a warpgroup owns 64 keys (the M of one wgmma), whose K and
//     V tiles stay in shared memory; a block has two warpgroups (128 keys
//     sharing each streamed Q / dO tile, as kernel 8's two heads share
//     K / V) where the grid keeps 256 blocks, else one. Q, dO and their
//     lse and D rows stream through a ring of two stages, the next tile's
//     load in flight during this one's products. A tile: S^T = K Q^T and
//     dP^T = V dO^T (`wgmma_ss`, both operands K-major), P^T = 2^(S^T
//     scale log2 e - lse log2 e) on the fragment, lse and D taken by the
//     fragment's column (query); P^T rounded to bf16 in registers is the A
//     operand of dV += P^T dO, whose B is the dO tile read MN-major
//     (`wgmma_rs`), issued before dS^T = P^T (dP^T - D) is formed, so it
//     runs under that arithmetic; then dK += dS^T Q the same way. At the
//     end dk x scale and dv are written in bf16.
//   - dq: one or two warpgroups a block by the same rule (two query heads
//     of one kv head sharing each K / V tile), 64 query rows each; Q, dO
//     and the rows' lse and D stay put, K and V stream through the ring:
//     S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K with K read
//     MN-major.
//   P and dS are rounded to bf16 before their products, as FlashAttention
//   -2/3 do; the plain version keeps them in fp32. Against it that costs
//   ~2^-9 relative per term, inside the 2e-2 of each output's peak that
//   the gates hold (tests/test_torch_flash_bwd_rounding.py emulates the
//   roundings on the CPU against the JAX scan: 2.3-2.7e-3). Only the
//   diagonal, window-edge and ragged tiles are masked; a warpgroup skips
//   the products of a tile none of whose pairs it can see (a warpgroup-
//   uniform branch). Heavy tiles first: key block 0 (every query under a
//   causal mask) and the last query tiles lead the grids.
//   Shared memory: dk/dv 66 / 130 KB at D 64 / 128 with two warpgroups
//   (50 / 98 KB with one), dq 65 / 129 KB (49 / 97 KB). Registers (ptxas,
//   no spill at all): dk/dv 230 / 255 at D 64 / 128 (dk and dv D / 2 fp32
//   each a thread, S^T and dP^T 32 each, P^T and dS^T 16 packed words
//   each), dq 128 / 208; the D 64 dq kernel is held to 128 so that two
//   blocks share an SM, which made it faster on granite's layer. Granite's
//   train layer (B 4, 4096 tokens): 2.907 ms a call, 23.6 % of the bound,
//   from 56.57 ms on the CUDA cores (PERF.md section 6).
// * bf16 at D 256 (gemma2-9b): the same five products on wgmma, with D
//   split across the two warpgroups of a block (FlashAttention-3's layout
//   for this head dim), `flash_bwd_dkdv_wgmma_split_kernel<256>` and
//   `flash_bwd_dq_wgmma_split_kernel<256>`. The D 64 / 128 layout cannot
//   take it: a warpgroup owning 64 keys would hold dk and dv as 2 x 4
//   panels x 32 = 256 fp32 registers a thread.
//   - dk, dv: a block of two warpgroups owns one 64-key tile of one kv head
//     (K and V stay in shared memory, 64 KB). For each streamed (Q, dO)
//     tile, warpgroup w scores the query columns [32 w, 32 w + 32): S^T and
//     dP^T as m64n32 products over the full D (16 + 16 fp32 a thread), P^T
//     and dS^T on the fragment as above, written to shared memory in bf16
//     (two swizzled [64, 64] tiles, 8 KB each; the block's barrier then
//     makes both halves visible). Then warpgroup w accumulates dims [128 w,
//     128 w + 128) of dV += P^T dO and dK += dS^T Q (`wgmma_ss_kmn`: A
//     K-major from the P^T / dS^T tile, B the dO / Q panels 2 w, 2 w + 1
//     read MN-major), 2 x 2 panels x 32 = 128 fp32 a thread. GQA's sum over
//     the query heads stays a register sum in a fixed order. Issuing dV
//     before dS^T is formed (a second barrier, as the D 64 / 128 kernel
//     overlaps them) measured the same on an H100 (1.607-1.611 against
//     1.616-1.618 ms a call at [1, 16/8, 4096, 256]), so a tile keeps one
//     barrier after its scores.
//   - dq: a block of two warpgroups owns 64 query rows of one query head
//     (Q, dO stay); K and V stream through the ring; warpgroup w scores the
//     key columns [32 w, 32 w + 32), writes its half of dS in bf16, and
//     accumulates dims [128 w, 128 w + 128) of dQ += dS K.
//   P and dS are rounded to bf16 before their products, as at D 64 / 128,
//   so the same emulation covers them. Each half decides its own mask (on
//   a window's first or last tile one half can be wholly masked and the
//   other not); no tile is skipped: both warpgroups meet at the barriers
//   of every tile in the block's band. Shared memory: dk/dv 210 KB (K, V
//   64; a ring of two (Q, dO) stages 128; P^T, dS^T 16; lse and D rows 1;
//   alignment 1), dq 201 KB: one block of 256 threads an SM. Registers
//   (ptxas, no spill): dk/dv 222, dq 154. On an H100: 1.61-1.67 ms a call
//   at [1, 16/8, 4096, 256], cap 50 (20.3-21.6 % of the bound; dk/dv 0.86
//   ms, dq 0.72), 6.41-6.47 ms on gemma2's train layer [4, 16/8, 4096,
//   256] (21.7-22.1 %), from 49.91 ms on the CUDA cores (PERF.md section 6).
// * fp32: the CUDA-core kernels of the first port, `flash_bwd_dkdv_kernel<D>`
//   and `flash_bwd_dq_kernel<D>`, with `flash_bwd_delta_kernel`. fp32 stays
//   exact (FMAs from shared memory), which the depth-2 fp32 gradient gate of
//   chip_smoke.py and the fp32 card tests read at 1e-3 / 2e-5.
//   Tiles: 64 query rows; 64 / 32 / 16 keys at D 64 / 128 / 256 (dk and dv
//   64 fp32 registers a thread at every D), staged as fp32 with rows padded
//   by one word; lanes on keys, warps on rows. Shared memory 98 / 113 /
//   169 KB a block.
//
// Inputs are addressed by strides (elements; the last dim contiguous), so
// the model layout [B, S, H, D] is read and written in place; lse and D
// are [B, Hq, Sq] fp32 contiguous. bf16 rows must start on 16 bytes (the
// wrapper checks).

#include "common.cuh"
#include "wgmma.cuh"

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

__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const BwdArgs a, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.batch) * a.hq * a.sq) return;  // warp-uniform
  const int s = static_cast<int>(row % a.sq);
  const long long bh = row / a.sq;
  const int h = static_cast<int>(bh % a.hq), b = static_cast<int>(bh / a.hq);
  const float* o = static_cast<const float*>(a.o) +
      b * a.os[0] + h * a.os[1] + s * a.os[2];
  const float* g = static_cast<const float*>(a.dout) +
      b * a.gs[0] + h * a.gs[1] + s * a.gs[2];
  float acc = 0.0f;
  for (int i = lane; i < d; i += 32) acc = fmaf(o[i], g[i], acc);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[row] = acc;
}

// bf16: 16-byte loads, D / 8 lanes a row (a warp takes 256 / D rows)
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_bf16_kernel(const BwdArgs a) {
  constexpr int L = D / 8;     // lanes a row, 8 bf16 each
  constexpr int RW = 32 / L;   // rows a warp
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * kWarps +
                         threadIdx.x / 32) * RW + lane / L;
  const bool in = row < static_cast<long long>(a.batch) * a.hq * a.sq;
  float acc = 0.0f;
  if (in) {
    const int s = static_cast<int>(row % a.sq);
    const long long bh = row / a.sq;
    const int h = static_cast<int>(bh % a.hq), b = static_cast<int>(bh / a.hq);
    const int c = (lane % L) * 8;
    float x[8], y[8];
    load8(static_cast<const __nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[1] +
              s * a.os[2] + c, x);
    load8(static_cast<const __nv_bfloat16*>(a.dout) + b * a.gs[0] +
              h * a.gs[1] + s * a.gs[2] + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
  }
  // every lane takes part in the shuffles, in or out
#pragma unroll
  for (int off = L / 2; off; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (in && lane % L == 0) a.delta[row] = acc;
}

// -- CUDA cores (fp32): shared by passes 2 and 3 ------------------------------

// rows [0, kBQ) of q and dO from row q0 into padded fp32 tiles, lse and D
// beside them (zeros past Sq)
template <int D>
__device__ __forceinline__ void load_rows(const BwdArgs& a, const float* qb,
                                          const float* gb, const float* lb,
                                          const float* db, int q0, float* sQ,
                                          float* sG, float* sL, float* sD) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D, s = q0 + r;
    const bool in = s < a.sq;
    sQ[r * P + c] = in ? qb[s * a.qs[2] + c] : 0.0f;
    sG[r * P + c] = in ? gb[s * a.gs[2] + c] : 0.0f;
  }
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < a.sq;
    sL[r] = in ? lb[q0 + r] : 0.0f;
    sD[r] = in ? db[q0 + r] : 0.0f;
  }
}

// keys [0, BK) of k and v from key k0 into padded fp32 tiles
template <int D, int BK>
__device__ __forceinline__ void load_keys(const BwdArgs& a, const float* kb,
                                          const float* vb, int k0, float* sK,
                                          float* sV) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int j = i / D, c = i - j * D, kp = k0 + j;
    const bool in = kp < a.skv;
    sK[j * P + c] = in ? kb[kp * a.ks[2] + c] : 0.0f;
    sV[j * P + c] = in ? vb[kp * a.vs[2] + c] : 0.0f;
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

template <int D>
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
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  load_keys<D, BK>(a, kb, vb, k0, sK, sV);

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
    const float* qb = static_cast<const float*>(a.q) +
        b * a.qs[0] + h * a.qs[1];
    const float* gb = static_cast<const float*>(a.dout) +
        b * a.gs[0] + h * a.gs[1];
    const long long row = (static_cast<long long>(b) * a.hq + h) * a.sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // every thread is done with the previous tile
      load_rows<D>(a, qb, gb, a.lse + row, a.delta + row, q0, sQ, sG, sL,
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

  float* dkb = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  float* dvb = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int kp = k0 + warp * KW + j;
    if (kp < a.skv) {
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        dkb[kp * a.dks[2] + lane + 32 * e] = dk[j][e] * a.scale;
        dvb[kp * a.dvs[2] + lane + 32 * e] = dv[j][e];
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

template <int D>
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
  const float* qb = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* gb = static_cast<const float*>(a.dout) +
      b * a.gs[0] + h * a.gs[1];
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const long long row = (static_cast<long long>(b) * a.hq + h) * a.sq;
  load_rows<D>(a, qb, gb, a.lse + row, a.delta + row, q0, sQ, sG, sL, sD);

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
    load_keys<D, BK>(a, kb, vb, k0, sK, sV);
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

  float* dqb = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int s = q0 + warp * RW + i;
    if (s < a.sq) {
#pragma unroll
      for (int e = 0; e < DL; ++e)
        dqb[s * a.dqs[2] + lane + 32 * e] = dq[i][e] * a.scale;
    }
  }
}

// -- bf16 at D 64 and 128: the five products on wgmma ---------------------------

constexpr int kWB = 64;          // queries or keys a tile: one wgmma's M
constexpr int kWStages = 2;      // ring depth of the streamed tiles

template <int D, int NWG>
constexpr size_t dkdv_wgmma_smem_bytes() {
  // 1 KB of slack for the swizzle's 1024-byte alignment; K and V of each
  // warpgroup, then the ring of (Q, dO) tiles, then its (lse, D) rows
  return 1024 + 2 * (2 * NWG * kWB * D + kWStages * 2 * kWB * D) +
         kWStages * 2 * kWB * sizeof(float);
}

template <int D, int NWG>
constexpr size_t dq_wgmma_smem_bytes() {
  return 1024 + 2 * (2 * NWG * kWB * D + kWStages * 2 * kWB * D);
}

// S (+)= A B^T over D for two K-major [64, D] tiles at sa and sb (D / 16
// wgmmas of k16, 32 bytes along the swizzled row each)
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t sa,
                                           uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) << 5;
    wgmma_ss(d, desc_b128(sa + (kk >> 2) * kWB * 128 + off, 16, 1024),
             desc_b128(sb + (kk >> 2) * kWB * 128 + off, 16, 1024), kk > 0);
  }
}

// acc[j] += A B over 64 rows of B, A the four register fragments of a
// 64 x 64 accumulator (its columns as K), B a [64, D] tile at sb read
// MN-major: D / 64 panels of 64 columns, 16 rows a k-step
template <int NP>
__device__ __forceinline__ void product_rs(float (&acc)[NP][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < kWB / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      wgmma_rs(acc[j], a[kk],
               desc_b128(sb + j * kWB * 128 + kk * 16 * 128, kWB * 128,
                         1024));
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e])::"memory");
}

// Element i of a thread's m64n64 fragment sits at row 16 warp + lane / 4 +
// 8 ((i / 2) % 2) and column col_of(i) (wgmma.cuh).
__device__ __forceinline__ int col_of(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// The scores of a fragment s (raw q.k) turned in place into p, times the
// softcap's derivative 1 - tanh^2 where capped (what ds needs), with p
// itself rounded to bf16 pairs into pa when kPack. lse2(i) is element i's
// row log-sum-exp x log2 e; visible(i) whether its pair is seen (asked
// only in a masked tile). The cap and mask branches are uniform and sit
// outside the element loop: inside, every element would pay for both.
template <bool kCap, bool kMask, bool kPack, int N, typename Lse,
          typename Vis>
__device__ __forceinline__ void probs_of(float (&s)[N],
                                         uint32_t (&pa)[N / 8][4],
                                         const BwdArgs& a, Lse lse2,
                                         Vis visible) {
  const float scale_log2 = a.scale * kLog2e;
  const float inner = kCap ? a.scale / a.cap : 0.0f;
  const float outer = a.cap * kLog2e;
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    float p[2], f[2] = {1.0f, 1.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kCap) {
        const float t = tanh_fast(s[i + e] * inner);
        p[e] = ex2(outer * t - lse2(i + e));
        f[e] = 1.0f - t * t;
      } else {
        p[e] = ex2(s[i + e] * scale_log2 - lse2(i + e));
      }
      if (kMask && !visible(i + e)) p[e] = 0.0f;
      s[i + e] = p[e] * f[e];
    }
    // element pairs (i, i + 1) in fragment order: pa[i / 8][(i % 8) / 2]
    if (kPack) pa[i >> 3][(i & 7) >> 1] = pack_bf16(p[0], p[1]);
  }
}

template <bool kPack, int N, typename Lse, typename Vis>
__device__ __forceinline__ void probs(float (&s)[N], uint32_t (&pa)[N / 8][4],
                                      const BwdArgs& a, bool masked,
                                      Lse lse2, Vis visible) {
  if (a.cap != 0.0f) {
    if (masked) probs_of<true, true, kPack>(s, pa, a, lse2, visible);
    else probs_of<true, false, kPack>(s, pa, a, lse2, visible);
  } else {
    if (masked) probs_of<false, true, kPack>(s, pa, a, lse2, visible);
    else probs_of<false, false, kPack>(s, pa, a, lse2, visible);
  }
}

// ds = s (dp - D) rounded to bf16 pairs (s as probs left it: 0 where
// masked); dd(i) is the element's D
template <int N, typename Dd>
__device__ __forceinline__ void dscores(const float (&s)[N],
                                        const float (&dp)[N],
                                        uint32_t (&da)[N / 8][4], Dd dd) {
#pragma unroll
  for (int i = 0; i < N; i += 2)
    da[i >> 3][(i & 7) >> 1] = pack_bf16(s[i] * (dp[i] - dd(i)),
                                         s[i + 1] * (dp[i + 1] - dd(i + 1)));
}

// a thread's rows (row0, row0 + 8) of a [64, D] accumulator (NP panels)
// times `mul`, in bf16, to the same rows of out (row stride rs), those
// below `limit`
template <int NP>
__device__ __forceinline__ void store_rows(const float (&acc)[NP][32],
                                           __nv_bfloat16* out, long long rs,
                                           int row0, int limit, float mul,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = row0 + ((i & 2) ? 8 : 0);
      if (r < limit)
        *reinterpret_cast<__nv_bfloat162*>(out + r * rs + 64 * j +
                                           col_of(i, lane)) =
            __floats2bfloat162_rn(acc[j][i] * mul, acc[j][i + 1] * mul);
    }
}

// Pass 2: dk and dv of 64 NWG keys (64 a warpgroup) of one kv head.
template <int D, int NWG>
__global__ void __launch_bounds__(kThreads * NWG, 1)
    flash_bwd_dkdv_wgmma_kernel(const BwdArgs a) {
  constexpr int NT = kThreads * NWG;
  constexpr int NP = D / 64;
  constexpr uint32_t T_BYTES = kWB * D * 2;     // one [64, D] bf16 tile
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t s_k = base + wg * T_BYTES;            // this warpgroup's
  const uint32_t s_v = base + (NWG + wg) * T_BYTES;
  const uint32_t s_ring = base + 2 * NWG * T_BYTES;    // stage: Q, dO
  const uint32_t s_rows = s_ring + kWStages * 2 * T_BYTES;  // stage: lse, D
  const float* rows = reinterpret_cast<const float*>(smem_raw +
                                                     (s_rows - raw));

  // key block 0 sees every query tile under a causal mask: heavy first
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kb0 = blockIdx.z * NWG * kWB;         // the block's first key
  const int kw0 = kb0 + wg * kWB;                 // this warpgroup's
  const int g = a.hq / a.hkv;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int kw = kw0 < a.skv ? kw0 : 0;           // a row that exists
  load_tile<D, kWB, kThreads>(s_k, kb + kw * a.ks[2], a.ks[2], a.skv - kw0,
                              tid);
  load_tile<D, kWB, kThreads>(s_v, vb + kw * a.vs[2], a.vs[2], a.skv - kw0,
                              tid);

  // the query rows that see a key of this block: from its first key under
  // a causal mask, to its last key + window - 1 under a window
  const int k_last = min(kb0 + NWG * kWB, a.skv) - 1;
  const int q_begin = a.causal ? (kb0 / kWB) * kWB : 0;
  const int q_end = a.window ? min(a.sq, k_last + a.window) : a.sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + kWB - 1) / kWB : 0;
  const int n_tiles = g * nq;   // query head outer, query tile inner

  // tile j into ring stage j % kWStages, one commit group each (empty past
  // the end, so that the count of groups stays uniform); the first group
  // also holds K and V
  auto load_q = [&](int j) {
    if (j < n_tiles) {
      const int h = hk * g + j / nq, q0 = q_begin + (j % nq) * kWB;
      const uint32_t st = s_ring + (j % kWStages) * 2 * T_BYTES;
      load_tile<D, kWB, NT>(st, static_cast<const bf16*>(a.q) + b * a.qs[0] +
                                    h * a.qs[1] + q0 * a.qs[2],
                            a.qs[2], a.sq - q0, threadIdx.x);
      load_tile<D, kWB, NT>(st + T_BYTES,
                            static_cast<const bf16*>(a.dout) + b * a.gs[0] +
                                h * a.gs[1] + q0 * a.gs[2],
                            a.gs[2], a.sq - q0, threadIdx.x);
      if (threadIdx.x < 2 * kWB) {          // lse (0-63), then D (64-127)
        const int r = threadIdx.x % kWB;
        const bool ok = q0 + r < a.sq;
        const float* src = (threadIdx.x < kWB ? a.lse : a.delta) +
                           (static_cast<long long>(b) * a.hq + h) * a.sq +
                           (ok ? q0 + r : 0);
        cp_async4(s_rows + ((j % kWStages) * 2 * kWB + threadIdx.x) * 4, src,
                  ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kWStages - 1; ++j) load_q(j);

  // this thread's two keys (fragment rows)
  const int kp0 = kw0 + 16 * warp + (lane >> 2), kp1 = kp0 + 8;
  float dk[NP][32], dv[NP][32], s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[j][i] = dv[j][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, every thread is done with tile t - 1 (whose stage
    // the next load overwrites), and wgmma (the async proxy) sees it
    cp_async_wait<kWStages - 2>();
    fence_proxy_async();
    __syncthreads();
    load_q(t + kWStages - 1);
    const int q0 = q_begin + (t % nq) * kWB;
    const int q_hi = min(q0 + kWB, a.sq) - 1;
    // skip a tile none of whose pairs this warpgroup sees
    if (kw0 >= a.skv || (a.causal && q_hi < kw0) ||
        (a.window && q0 >= kw0 + kWB - 1 + a.window))
      continue;
    const uint32_t s_q = s_ring + (t % kWStages) * 2 * T_BYTES;
    const uint32_t s_g = s_q + T_BYTES;
    const float* lse_t = rows + (t % kWStages) * 2 * kWB;
    const float* d_t = lse_t + kWB;

    // S^T = K Q^T and dP^T = V dO^T: keys x queries, two groups
    wgmma_fence();
    product_ss<D>(s, s_k, s_q);
    wgmma_commit();
    product_ss<D>(dp, s_v, s_g);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // masks only where the tile crosses the diagonal, the window's edge or
    // an end of the queries or keys
    const bool masked = kw0 + kWB > a.skv || q0 + kWB > a.sq ||
                        (a.causal && q0 < kw0 + kWB - 1) ||
                        (a.window && q0 + kWB - 1 - a.window >= kw0);
    probs<true>(s, pa, a, masked,
                [&](int i) { return lse_t[col_of(i, lane)] * kLog2e; },
                [&](int i) {
                  const int kp = (i & 2) ? kp1 : kp0;
                  const int qp = q0 + col_of(i, lane);
                  return kp < a.skv && qp < a.sq && (!a.causal || kp <= qp) &&
                         (!a.window || kp > qp - a.window);
                });
    // dV += P^T dO runs while dS^T is formed
    wgmma_fence();
    product_rs<NP>(dv, pa, s_g);
    wgmma_commit();
    wgmma_wait<1>();     // dP^T (the older group) has landed
    fence_regs(dp);
    dscores(s, dp, da, [&](int i) { return d_t[col_of(i, lane)]; });
    wgmma_fence();
    product_rs<NP>(dk, da, s_q);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      fence_regs(dv[j]);
      fence_regs(dk[j]);
    }
    fence_frags(pa);
    fence_frags(da);
  }
  cp_async_wait<0>();

  const int r0 = 16 * warp + (lane >> 2);
  store_rows<NP>(dk, static_cast<bf16*>(a.dk) + b * a.dks[0] + hk * a.dks[1] +
                         kw0 * a.dks[2],
                 a.dks[2], r0, a.skv - kw0, a.scale, lane);
  store_rows<NP>(dv, static_cast<bf16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1] +
                         kw0 * a.dvs[2],
                 a.dvs[2], r0, a.skv - kw0, 1.0f, lane);
}

// Pass 3: dq of 64 query rows of NWG query heads of one kv head. At D 64
// the kernel is held to 128 registers (no spill) so that two blocks share
// an SM (see the header).
template <int D, int NWG>
__global__ void __launch_bounds__(kThreads * NWG, D == 64 ? 2 : 1)
    flash_bwd_dq_wgmma_kernel(const BwdArgs a) {
  constexpr int NT = kThreads * NWG;
  constexpr int NP = D / 64;
  constexpr uint32_t T_BYTES = kWB * D * 2;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t s_q = base + wg * T_BYTES;           // this warpgroup's
  const uint32_t s_g = base + (NWG + wg) * T_BYTES;
  const uint32_t s_kv = base + 2 * NWG * T_BYTES;     // stage: K, then V

  // the last query tiles see the most keys under a causal mask: first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWB;
  const int h = blockIdx.x * NWG + wg, b = blockIdx.y;
  const int hk = h / (a.hq / a.hkv);
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  load_tile<D, kWB, kThreads>(s_q, static_cast<const bf16*>(a.q) +
                                       b * a.qs[0] + h * a.qs[1] +
                                       q0 * a.qs[2],
                              a.qs[2], a.sq - q0, tid);
  load_tile<D, kWB, kThreads>(s_g, static_cast<const bf16*>(a.dout) +
                                       b * a.gs[0] + h * a.gs[1] +
                                       q0 * a.gs[2],
                              a.gs[2], a.sq - q0, tid);

  // the band of keys any row of this block can see
  const int q_last = min(q0 + kWB, a.sq) - 1;
  const int k_end = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int k_begin = a.window ? (max(0, q0 - a.window + 1) / kWB) * kWB : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWB - 1) / kWB : 0;

  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = s_kv + (j % kWStages) * 2 * T_BYTES;
      const int kn = k_begin + j * kWB;
      load_tile<D, kWB, NT>(st, kb + kn * a.ks[2], a.ks[2], a.skv - kn,
                            threadIdx.x);
      load_tile<D, kWB, NT>(st + T_BYTES, vb + kn * a.vs[2], a.vs[2],
                            a.skv - kn, threadIdx.x);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kWStages - 1; ++j) load_kv(j);

  // this thread's two query rows, their lse (x log2 e) and D
  const int r0 = 16 * warp + (lane >> 2);
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  const long long row = (static_cast<long long>(b) * a.hq + h) * a.sq;
  const float l0 = qp0 < a.sq ? a.lse[row + qp0] * kLog2e : 0.0f;
  const float l1 = qp1 < a.sq ? a.lse[row + qp1] * kLog2e : 0.0f;
  const float d0 = qp0 < a.sq ? a.delta[row + qp0] : 0.0f;
  const float d1 = qp1 < a.sq ? a.delta[row + qp1] : 0.0f;

  float dq[NP][32], s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[j][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kWB;
    cp_async_wait<kWStages - 2>();
    fence_proxy_async();
    __syncthreads();
    load_kv(t + kWStages - 1);
    const uint32_t s_k = s_kv + (t % kWStages) * 2 * T_BYTES;
    const uint32_t s_v = s_k + T_BYTES;

    // S = Q K^T and dP = dO V^T: queries x keys
    wgmma_fence();
    product_ss<D>(s, s_q, s_k);
    wgmma_commit();
    product_ss<D>(dp, s_g, s_v);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const bool masked = k0 + kWB > a.skv ||
                        (a.causal && k0 + kWB - 1 > q0) ||
                        (a.window && k0 <= q0 + kWB - 1 - a.window);
    probs<false>(s, pa, a, masked, [&](int i) { return (i & 2) ? l1 : l0; },
                 [&](int i) {
                   const int kp = k0 + col_of(i, lane);
                   const int qp = (i & 2) ? qp1 : qp0;
                   return kp < a.skv && (!a.causal || kp <= qp) &&
                          (!a.window || kp > qp - a.window);
                 });
    wgmma_wait<0>();
    fence_regs(dp);
    dscores(s, dp, da, [&](int i) { return (i & 2) ? d1 : d0; });
    // dQ += dS K, K read MN-major
    wgmma_fence();
    product_rs<NP>(dq, da, s_k);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NP; ++j) fence_regs(dq[j]);
    fence_frags(da);
  }
  cp_async_wait<0>();

  store_rows<NP>(dq, static_cast<bf16*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] +
                         q0 * a.dqs[2],
                 a.dqs[2], r0, a.sq - q0, a.scale, lane);
}

// -- bf16 at D 256: D split across two warpgroups ------------------------------

constexpr int kHalf = kWB / 2;   // score columns (queries or keys) a warpgroup

template <int D>
constexpr size_t dkdv_split_smem_bytes() {
  // 1 KB of slack for the swizzle's alignment; K and V, the ring of (Q, dO)
  // tiles, P^T and dS^T [64, 64], then the ring's (lse, D) rows
  return 1024 + 2 * (2 * kWB * D + kWStages * 2 * kWB * D + 2 * kWB * kWB) +
         kWStages * 2 * kWB * sizeof(float);
}

template <int D>
constexpr size_t dq_split_smem_bytes() {
  // slack; Q and dO, the ring of (K, V) tiles, dS [64, 64]
  return 1024 + 2 * (2 * kWB * D + kWStages * 2 * kWB * D + kWB * kWB);
}

// the card's 227 KB a block (one block an SM)
static_assert(dkdv_split_smem_bytes<256>() <= 232448, "dk/dv smem");
static_assert(dq_split_smem_bytes<256>() <= 232448, "dq smem");

// S (+)= A B^T over D, m64n32: A a K-major [64, D] tile at sa, B 32 rows of
// a K-major [64, D] tile (sb: the tile's base plus its first row x 128)
template <int D>
__device__ __forceinline__ void product_ss_half(float (&d)[16], uint32_t sa,
                                                uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) << 5;
    wgmma_ss_n32(d, desc_b128(sa + (kk >> 2) * kWB * 128 + off, 16, 1024),
                 desc_b128(sb + (kk >> 2) * kWB * 128 + off, 16, 1024),
                 kk > 0);
  }
}

// acc[j] += A B over 64 rows of B: A a K-major [64, 64] bf16 tile at sa
// (one panel), B NP panels of 64 columns of a tile read MN-major from sb
template <int NP>
__device__ __forceinline__ void product_ss_mn(float (&acc)[NP][32],
                                              uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < kWB / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      wgmma_ss_kmn(acc[j], desc_b128(sa + (kk << 5), 16, 1024),
                   desc_b128(sb + j * kWB * 128 + kk * 16 * 128, kWB * 128,
                             1024));
}

// A thread's bf16 pairs of an m64n32 fragment (probs / dscores order) into
// columns col0 ... col0 + 31 of the swizzled [64, 64] tile at s: word
// pa[kk][e] is row r0 + 8 (e % 2), columns col0 + 16 kk + 8 (e / 2) +
// 2 (lane % 4) and the next. A warp's 32 words of one (kk, e) fill eight
// rows' 16 bytes of one swizzled chunk: eight distinct chunks, no bank
// conflict.
__device__ __forceinline__ void store_half(uint32_t s,
                                           const uint32_t (&pa)[2][4],
                                           int r0, int col0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1);
      const int c = (col0 + 16 * kk + 8 * (e >> 1)) >> 3;
      st_shared_u32(s + swz(r, c, kWB) + 4 * (lane & 3), pa[kk][e]);
    }
}

// Pass 2 at D 256: dk and dv of 64 keys of one kv head. Warpgroup w scores
// the query columns [32 w, 32 w + 32) of each tile (S^T and dP^T m64n32
// over the full D), writes its half of P^T and dS^T to shared memory in
// bf16, and after the block's barrier accumulates dims [D w / 2, D (w + 1)
// / 2) of dV += P^T dO and dK += dS^T Q from shared memory.
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkdv_wgmma_split_kernel(const BwdArgs a) {
  constexpr int NT = 2 * kThreads;
  constexpr int NP = D / 128;                   // panels of half of D
  constexpr uint32_t T_BYTES = kWB * D * 2;     // one [64, D] bf16 tile
  constexpr uint32_t S_BYTES = kWB * kWB * 2;   // one [64, 64] bf16 tile
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t s_k = base, s_v = base + T_BYTES;
  const uint32_t s_ring = base + 2 * T_BYTES;           // stage: Q, dO
  const uint32_t s_p = s_ring + kWStages * 2 * T_BYTES;  // P^T [key][query]
  const uint32_t s_ds = s_p + S_BYTES;                   // dS^T
  const uint32_t s_rows = s_ds + S_BYTES;                // stage: lse, D
  const float* rows = reinterpret_cast<const float*>(smem_raw +
                                                     (s_rows - raw));

  // key block 0 sees every query tile under a causal mask: heavy first
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kWB;
  const int g = a.hq / a.hkv;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  load_tile<D, kWB, NT>(s_k, kb + k0 * a.ks[2], a.ks[2], a.skv - k0,
                        threadIdx.x);
  load_tile<D, kWB, NT>(s_v, vb + k0 * a.vs[2], a.vs[2], a.skv - k0,
                        threadIdx.x);

  // the query rows that see a key of this block (as the D 64 / 128 kernel)
  const int k_last = min(k0 + kWB, a.skv) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window ? min(a.sq, k_last + a.window) : a.sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + kWB - 1) / kWB : 0;
  const int n_tiles = g * nq;   // query head outer, query tile inner

  auto load_q = [&](int j) {
    if (j < n_tiles) {
      const int h = hk * g + j / nq, q0 = q_begin + (j % nq) * kWB;
      const uint32_t st = s_ring + (j % kWStages) * 2 * T_BYTES;
      load_tile<D, kWB, NT>(st, static_cast<const bf16*>(a.q) + b * a.qs[0] +
                                    h * a.qs[1] + q0 * a.qs[2],
                            a.qs[2], a.sq - q0, threadIdx.x);
      load_tile<D, kWB, NT>(st + T_BYTES,
                            static_cast<const bf16*>(a.dout) + b * a.gs[0] +
                                h * a.gs[1] + q0 * a.gs[2],
                            a.gs[2], a.sq - q0, threadIdx.x);
      if (threadIdx.x < 2 * kWB) {          // lse (0-63), then D (64-127)
        const int r = threadIdx.x % kWB;
        const bool ok = q0 + r < a.sq;
        const float* src = (threadIdx.x < kWB ? a.lse : a.delta) +
                           (static_cast<long long>(b) * a.hq + h) * a.sq +
                           (ok ? q0 + r : 0);
        cp_async4(s_rows + ((j % kWStages) * 2 * kWB + threadIdx.x) * 4, src,
                  ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kWStages - 1; ++j) load_q(j);

  // this thread's two keys (fragment rows), its warpgroup's query columns
  const int r0 = 16 * warp + (lane >> 2);
  const int kp0 = k0 + r0, kp1 = kp0 + 8;
  const int col0 = kHalf * wg;
  float dk[NP][32], dv[NP][32], s[16], dp[16];
  uint32_t pa[2][4], da[2][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[j][i] = dv[j][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed; every thread is done with tile t - 1 (its ring
    // stage, which the next load overwrites, and P^T / dS^T)
    cp_async_wait<kWStages - 2>();
    fence_proxy_async();
    __syncthreads();
    load_q(t + kWStages - 1);
    const int q0 = q_begin + (t % nq) * kWB;
    const uint32_t s_q = s_ring + (t % kWStages) * 2 * T_BYTES;
    const uint32_t s_g = s_q + T_BYTES;
    const float* lse_t = rows + (t % kWStages) * 2 * kWB + col0;
    const float* d_t = lse_t + kWB;

    // this half's S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries
    wgmma_fence();
    product_ss_half<D>(s, s_k, s_q + col0 * 128);
    wgmma_commit();
    product_ss_half<D>(dp, s_v, s_g + col0 * 128);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // masks where this half crosses the diagonal, the window's edge or an
    // end of the queries or keys (the other half may not)
    const int qh = q0 + col0;
    const bool masked = k0 + kWB > a.skv || qh + kHalf > a.sq ||
                        (a.causal && qh < k0 + kWB - 1) ||
                        (a.window && qh + kHalf - 1 - a.window >= k0);
    probs<true>(s, pa, a, masked,
                [&](int i) { return lse_t[col_of(i, lane)] * kLog2e; },
                [&](int i) {
                  const int kp = (i & 2) ? kp1 : kp0;
                  const int qp = qh + col_of(i, lane);
                  return kp < a.skv && qp < a.sq && (!a.causal || kp <= qp) &&
                         (!a.window || kp > qp - a.window);
                });
    wgmma_wait<0>();
    fence_regs(dp);
    dscores(s, dp, da, [&](int i) { return d_t[col_of(i, lane)]; });
    store_half(s_p, pa, r0, col0, lane);
    store_half(s_ds, da, r0, col0, lane);
    // both halves of P^T and dS^T written, and visible to wgmma
    fence_proxy_async();
    __syncthreads();

    // this warpgroup's half of D: dV += P^T dO, dK += dS^T Q
    wgmma_fence();
    product_ss_mn<NP>(dv, s_p, s_g + wg * NP * kWB * 128);
    product_ss_mn<NP>(dk, s_ds, s_q + wg * NP * kWB * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      fence_regs(dv[j]);
      fence_regs(dk[j]);
    }
  }
  cp_async_wait<0>();

  store_rows<NP>(dk, static_cast<bf16*>(a.dk) + b * a.dks[0] + hk * a.dks[1] +
                         k0 * a.dks[2] + wg * NP * 64,
                 a.dks[2], r0, a.skv - k0, a.scale, lane);
  store_rows<NP>(dv, static_cast<bf16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1] +
                         k0 * a.dvs[2] + wg * NP * 64,
                 a.dvs[2], r0, a.skv - k0, 1.0f, lane);
}

// Pass 3 at D 256: dq of 64 query rows of one query head. Warpgroup w
// scores the key columns [32 w, 32 w + 32) of each streamed K / V tile,
// writes its half of dS to shared memory in bf16, and after the barrier
// accumulates dims [D w / 2, D (w + 1) / 2) of dQ += dS K.
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dq_wgmma_split_kernel(const BwdArgs a) {
  constexpr int NT = 2 * kThreads;
  constexpr int NP = D / 128;
  constexpr uint32_t T_BYTES = kWB * D * 2;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t s_q = base, s_g = base + T_BYTES;
  const uint32_t s_kv = base + 2 * T_BYTES;              // stage: K, then V
  const uint32_t s_ds = s_kv + kWStages * 2 * T_BYTES;   // dS [query][key]

  // the last query tiles see the most keys under a causal mask: first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWB;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.hq / a.hkv);
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  load_tile<D, kWB, NT>(s_q, static_cast<const bf16*>(a.q) + b * a.qs[0] +
                                 h * a.qs[1] + q0 * a.qs[2],
                        a.qs[2], a.sq - q0, threadIdx.x);
  load_tile<D, kWB, NT>(s_g, static_cast<const bf16*>(a.dout) + b * a.gs[0] +
                                 h * a.gs[1] + q0 * a.gs[2],
                        a.gs[2], a.sq - q0, threadIdx.x);

  // the band of keys any row of this block can see
  const int q_last = min(q0 + kWB, a.sq) - 1;
  const int k_end = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int k_begin = a.window ? (max(0, q0 - a.window + 1) / kWB) * kWB : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWB - 1) / kWB : 0;

  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = s_kv + (j % kWStages) * 2 * T_BYTES;
      const int kn = k_begin + j * kWB;
      load_tile<D, kWB, NT>(st, kb + kn * a.ks[2], a.ks[2], a.skv - kn,
                            threadIdx.x);
      load_tile<D, kWB, NT>(st + T_BYTES, vb + kn * a.vs[2], a.vs[2],
                            a.skv - kn, threadIdx.x);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kWStages - 1; ++j) load_kv(j);

  // this thread's two query rows, their lse (x log2 e) and D
  const int r0 = 16 * warp + (lane >> 2);
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  const long long row = (static_cast<long long>(b) * a.hq + h) * a.sq;
  const float l0 = qp0 < a.sq ? a.lse[row + qp0] * kLog2e : 0.0f;
  const float l1 = qp1 < a.sq ? a.lse[row + qp1] * kLog2e : 0.0f;
  const float d0 = qp0 < a.sq ? a.delta[row + qp0] : 0.0f;
  const float d1 = qp1 < a.sq ? a.delta[row + qp1] : 0.0f;
  const int col0 = kHalf * wg;

  float dq[NP][32], s[16], dp[16];
  uint32_t pa[2][4], da[2][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[j][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kWB;
    cp_async_wait<kWStages - 2>();
    fence_proxy_async();
    __syncthreads();
    load_kv(t + kWStages - 1);
    const uint32_t s_k = s_kv + (t % kWStages) * 2 * T_BYTES;
    const uint32_t s_v = s_k + T_BYTES;

    // this half's S = Q K^T and dP = dO V^T: 64 queries x 32 keys
    wgmma_fence();
    product_ss_half<D>(s, s_q, s_k + col0 * 128);
    wgmma_commit();
    product_ss_half<D>(dp, s_g, s_v + col0 * 128);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const int kh = k0 + col0;
    const bool masked = kh + kHalf > a.skv ||
                        (a.causal && kh + kHalf - 1 > q0) ||
                        (a.window && kh <= q0 + kWB - 1 - a.window);
    probs<false>(s, pa, a, masked, [&](int i) { return (i & 2) ? l1 : l0; },
                 [&](int i) {
                   const int kp = kh + col_of(i, lane);
                   const int qp = (i & 2) ? qp1 : qp0;
                   return kp < a.skv && (!a.causal || kp <= qp) &&
                          (!a.window || kp > qp - a.window);
                 });
    wgmma_wait<0>();
    fence_regs(dp);
    dscores(s, dp, da, [&](int i) { return (i & 2) ? d1 : d0; });
    store_half(s_ds, da, r0, col0, lane);
    fence_proxy_async();
    __syncthreads();

    // this warpgroup's half of D: dQ += dS K, K read MN-major
    wgmma_fence();
    product_ss_mn<NP>(dq, s_ds, s_k + wg * NP * kWB * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NP; ++j) fence_regs(dq[j]);
  }
  cp_async_wait<0>();

  store_rows<NP>(dq, static_cast<bf16*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] +
                         q0 * a.dqs[2] + wg * NP * 64,
                 a.dqs[2], r0, a.sq - q0, a.scale, lane);
}

// -- launches ---------------------------------------------------------------

int launch_delta(const BwdArgs& a, int d, bool bf16, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.batch) * a.hq * a.sq;
  if (!bf16) {
    flash_bwd_delta_kernel<<<static_cast<unsigned>(
        (rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(a, d);
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_block = static_cast<long long>(kWarps) * 256 / d;
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) /
                                              per_block);
  switch (d) {
    case 64: flash_bwd_delta_bf16_kernel<64><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 128: flash_bwd_delta_bf16_kernel<128><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 256: flash_bwd_delta_bf16_kernel<256><<<grid, kThreads, 0, stream>>>(a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// passes 2 and 3 on the CUDA cores (fp32)
template <int D>
int launch_cores(const BwdArgs& a, cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr int BK = block_k<D>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>,
                               dkdv_smem_bytes<D>(), dkdv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<D>, dq_smem_bytes<D>(), dq_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.skv + BK - 1) / BK, a.hkv, a.batch);
  flash_bwd_dkdv_kernel<D>
      <<<grid_kv, kThreads, dkdv_smem_bytes<D>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.sq + kBQ - 1) / kBQ, a.hq, a.batch);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, dq_smem_bytes<D>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Two warpgroups a block (two query heads sharing each K / V tile in dq,
// two key tiles sharing each Q / dO tile in dk / dv) where the grid keeps
// 256 blocks (kernel 8's rule), else one, for more blocks.
template <int D, int NWG>
int launch_dkdv_wgmma(const BwdArgs& a, cudaStream_t stream) {
  static bool ok = false;
  const size_t bytes = dkdv_wgmma_smem_bytes<D, NWG>();
  const cudaError_t err = allow_smem(flash_bwd_dkdv_wgmma_kernel<D, NWG>,
                                     bytes, ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.hkv, a.batch, (a.skv + NWG * kWB - 1) / (NWG * kWB));
  flash_bwd_dkdv_wgmma_kernel<D, NWG>
      <<<grid, kThreads * NWG, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NWG>
int launch_dq_wgmma(const BwdArgs& a, cudaStream_t stream) {
  static bool ok = false;
  const size_t bytes = dq_wgmma_smem_bytes<D, NWG>();
  const cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D, NWG>,
                                     bytes, ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.hq / NWG, a.batch, (a.sq + kWB - 1) / kWB);
  flash_bwd_dq_wgmma_kernel<D, NWG><<<grid, kThreads * NWG, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// passes 2 and 3 on the tensor cores
template <int D>
int launch_wgmma(const BwdArgs& a, cudaStream_t stream) {
  constexpr long long kMinBlocks = 256;
  const long long nk2 = (a.skv + 2 * kWB - 1) / (2 * kWB);
  const int err = nk2 * a.hkv * a.batch >= kMinBlocks
                      ? launch_dkdv_wgmma<D, 2>(a, stream)
                      : launch_dkdv_wgmma<D, 1>(a, stream);
  if (err) return err;
  const long long nq = (a.sq + kWB - 1) / kWB;
  if ((a.hq / a.hkv) % 2 == 0 && nq * (a.hq / 2) * a.batch >= kMinBlocks)
    return launch_dq_wgmma<D, 2>(a, stream);
  return launch_dq_wgmma<D, 1>(a, stream);
}

// passes 2 and 3 at D 256: one block of two warpgroups per 64 keys (dk,
// dv) and per 64 query rows of a query head (dq)
template <int D>
int launch_wgmma_split(const BwdArgs& a, cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_wgmma_split_kernel<D>,
                               dkdv_split_smem_bytes<D>(), dkdv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_wgmma_split_kernel<D>,
                     dq_split_smem_bytes<D>(), dq_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(a.hkv, a.batch, (a.skv + kWB - 1) / kWB);
  flash_bwd_dkdv_wgmma_split_kernel<D>
      <<<grid_kv, 2 * kThreads, dkdv_split_smem_bytes<D>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(a.hq, a.batch, (a.sq + kWB - 1) / kWB);
  flash_bwd_dq_wgmma_split_kernel<D>
      <<<grid_q, 2 * kThreads, dq_split_smem_bytes<D>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_all(const BwdArgs& a, int d, bool bf16, cudaStream_t stream) {
  if (d != 64 && d != 128 && d != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_delta(a, d, bf16, stream);
  if (err) return err;
  if (bf16) {
    switch (d) {
      case 64: return launch_wgmma<64>(a, stream);
      case 128: return launch_wgmma<128>(a, stream);
      default: return launch_wgmma_split<256>(a, stream);
    }
  }
  switch (d) {
    case 64: return launch_cores<64>(a, stream);
    case 128: return launch_cores<128>(a, stream);
    default: return launch_cores<256>(a, stream);
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
  return launch_all(a, static_cast<int>(dims[5]), is_bf16 != 0,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
