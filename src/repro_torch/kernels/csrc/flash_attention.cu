// Forward flash attention for Hopper (sm_90a): GQA, causal mask, sliding
// window (kpos > qpos - window), softcap cap * tanh(s / cap), fp32 online
// softmax with NEG_INF = -2^30, fp32 accumulation, fp32 or bf16 storage.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, pallas_call at :103). The TPU kernel walks a
// sequential kv grid axis and carries m, l and the accumulator in VMEM
// scratch; here a block owns a tile of query rows of one (batch, head) at a
// time and loops over the kv tiles itself, so nothing is carried between
// blocks. Query head h reads kv head h / (Hq / Hkv). The tiles that lie
// wholly outside the causal / window band of a tile's rows are never
// loaded: the loop runs from the first tile with k_end > q_start - window
// to the last with k_start <= q_end, the TPU kernel's skip.
//
// Bound: the live FLOPs (4 * D per unmasked (q, k) pair and head) at the
// tensor cores' rate against the bytes (q, k, v, o once each); for
// granite's heads (32/8, D 64) the bytes bound below ~740 tokens and the
// operations above. The softmax's exponentials bound it too: one MUFU ex2
// a live pair, and the SM's 16 a clock against its 4,096 bf16 FLOPs a
// clock make the ex2s as long as the products at D 64 and half as long at
// D 128, so the design keeps the two running side by side. Three kernels,
// picked by the storage type and the head dim:
//
// * bf16 at D 64 and 128 (every served and trained model but gemma2):
//   `flash_attention_ws_kernel<D>`, FlashAttention-3's shape.
//   - Block: 384 threads, one block an SM (persistent): a producer
//     warpgroup, of which one thread issues every load, and two consumer
//     warpgroups of 64 query rows each. setmaxnreg moves registers from
//     the producer (40 a thread) to the consumers (232). The work comes in
//     units of 128 query rows of one (batch, head), numbered longest first
//     (the last query tiles of every head, under a causal mask the most
//     keys); block g of G takes units g, 2G - 1 - g, 2G + g, ..., so long
//     and short units alternate.
//   - Loads: q, k and v by TMA (tma.cuh; `cp.async.bulk.tensor`, 4-D maps
//     of (D, S, H, B) that the wrapper's `tma_map_geometry` describes and
//     the host encodes each call), a box of [128 rows][64] a 64-column
//     panel, written by the copy engine in the 128-byte swizzle that the
//     wgmma descriptors read ([D / 64 panels][rows][64], 16-byte chunk c of
//     row r at c ^ (r % 8)), zero-filled past Sq and Skv. Q has two slots
//     (the next unit's Q lands while this one's last tiles run); K and V
//     each a ring of 2 stages at D 128 and 4 at D 64, of 128-key tiles.
//     Every slot and stage has a full mbarrier (the producer's arrival
//     with the box bytes, completed by the copies) and an empty one (one
//     arrival from each of the 8 consumer warps once its products have
//     read it); a wait on phase parity n & 1 for the n-th filling, so the
//     producer's first wait on a fresh empty barrier (parity 1) passes.
//     The producer runs across units: K one tile ahead of V, as the
//     consumers take them.
//   - Products: S = Q K^T is m64n128k16 with both operands K-major from
//     shared memory; O += P V takes P from registers (the accumulator's
//     columns 16 kk .. 16 kk + 15 are A fragment kk) and V as an MN-major
//     B, one m64nDk16 a 16-key step (at D 128 the two panels lie the
//     descriptor's LBO apart). Both accumulate in fp32.
//   - Overlap, inside a warpgroup: tile t's S is issued, then O is
//     rescaled for tile t - 1, then P_{t-1} V_{t-1} is issued; the wait for
//     S_t lets P V run under tile t's softmax (FlashAttention-3's
//     Algorithm 2). Between warpgroups: named barriers 1 and 2 (256
//     threads) make the two consumers issue their products in turn, so one
//     consumer's softmax runs while the other's products do.
//   - Masks only on the tiles that cross a warpgroup's diagonal, its
//     window's edge or the end of the keys, on the S fragment; the branches
//     are uniform and sit outside the element loops.
//   - Shared memory: 2 Q slots + 2 x stages K / V tiles + 1 KB of
//     alignment + the barriers (ws_smem_bytes): 197,728 bytes (193 KB) at
//     D 128 (32 KB a Q slot and a tile, 2 stages), 165,024 (161 KB) at D 64
//     (16 KB, 4 stages), of the 227 KB a block may take; registers: O is
//     D / 2 fp32 a thread, S 64, P 32 packed words, no spills (ptxas).
// * bf16 at D 256 (gemma2): `flash_attention_wgmma_kernel<256, NWG>`, the
//   first tensor-core design. One warpgroup owns 64 query rows; both
//   products are m64n64k16 `wgmma`s (O is four 64-column panels), K and V
//   tiles of 64 keys come in by cp.async, 16 bytes a thread, into a ring of
//   two stages, one barrier a tile. One or two warpgroups a block
//   (launch_wgmma_256): two take two query heads of one kv head and share
//   each K / V tile. Shared memory 161 / 193 KB (one block an SM); O is 128
//   fp32 a thread. Blocks run the last query tiles first.
// Both bf16 kernels run the softmax in the log2 domain on `ex2.approx` (one
// MUFU op, a couple of ulps), the softcap's tanh built from it, and round
// P to bf16 before P V, as FlashAttention-2/3 do (the TPU's MXU is fed bf16
// the same way at default precision); l sums the fp32 p. Against the plain
// version (fp32 P) that costs at most about 2^-9 relative per product, well
// inside the bf16 tolerance (2e-2); the chip rows of PERF.md give the
// max-abs it reads at the served shapes. They need 16-byte aligned rows
// (the wrapper checks; TMA needs the same of every stride).
// * fp32: `flash_attention_kernel`, the CUDA-core kernel of the first
//   port, unchanged. It is exact fp32 (FMAs from shared memory), which
//   the fp32 prefill-logits gate of chip_smoke.py reads at ~3e-6 relative
//   L2 against a limit of 1e-3; TF32 wgmma rounds each product to ~1e-3
//   relative and would put the kernel at that limit. Tiles are staged in
//   shared memory as fp32, a K row padded by one word so that lanes
//   reading different keys hit different banks; each of the 4 warps owns
//   BQ / 4 query rows, a lane owns 2 keys of a 64-key tile for the scores
//   and D / 32 output dims for P V.
//
// Inputs are addressed by strides (elements; the last dim contiguous), so
// the model layout [B, S, H, D] and the kernel layout [B, H, S, D] are
// both read without a copy. No atomics: a rerun gives the same bits.
//
// Optionally (lse != nullptr, the training path's forward) every kernel
// also writes each row's log-sum-exp, lse = m + log(max(l, 1e-20)) in fp32
// ([B, Hq, Sq] contiguous), as src/repro/models/flash_vjp.py's forward
// returns it for its backward (csrc/flash_attention_bwd.cu). It is written
// after the output and touches none of its arithmetic, so o is the same
// with or without it.

#include <algorithm>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro_kernels;

constexpr float kNegInf = -1073741824.0f;  // -2^30, as the TPU kernel
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;  // keys per tile

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Hq, Sq] row log-sum-exp, or nullptr
  int batch, hq, hkv, sq, skv;
  long long qs[3], ks[3], vs[3], os[3];  // strides of (b, h, s)
  int causal, window;
  float cap, scale;
};

template <int D>
__host__ __device__ constexpr int block_q() {
  return D <= 128 ? 64 : 32;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (block_q<D>() * D + kBK * (D + 1) + kBK * D +
                          block_q<D>() * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const FlashArgs a) {
  constexpr int BQ = block_q<D>();
  constexpr int RW = BQ / kWarps;  // query rows per warp
  constexpr int DL = D / 32;       // output dims per lane
  constexpr int KP = D + 1;        // padded K row
  extern __shared__ float smem[];
  float* sQ = smem;           // [BQ][D]
  float* sK = sQ + BQ * D;    // [kBK][D + 1]
  float* sV = sK + kBK * KP;  // [kBK][D]
  float* sP = sV + kBK * D;   // [BQ][kBK] probabilities of the tile

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  T* ob = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D, s = q_start + r;
    sQ[i] = s < a.sq ? to_f(qb[s * a.qs[2] + d]) : 0.0f;
  }
  float m[RW], l[RW], acc[RW][DL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[r][j] = 0.0f;
  }

  // the band of keys any row of this block can see
  const int q_last = min(q_start + BQ, a.sq) - 1;
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = a.window ? max(0, q_start - a.window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i - j * D, kp = k0 + j;
      const bool in = kp < a.skv;
      sK[j * KP + d] = in ? to_f(kb[kp * a.ks[2] + d]) : 0.0f;
      sV[j * D + d] = in ? to_f(vb[kp * a.vs[2] + d]) : 0.0f;
    }
    __syncthreads();

    // scores of the warp's rows against keys lane and lane + 32
    float s0[RW], s1[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s0[r] = s1[r] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = sK[lane * KP + d];
      const float k1v = sK[(lane + 32) * KP + d];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float qv = sQ[(warp * RW + r) * D + d];
        s0[r] = fmaf(qv, k0v, s0[r]);
        s1[r] = fmaf(qv, k1v, s1[r]);
      }
    }
    const int kp0 = k0 + lane, kp1 = kp0 + 32;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = warp * RW + r, qpos = q_start + row;
      float x0 = s0[r] * a.scale, x1 = s1[r] * a.scale;
      if (a.cap != 0.0f) {
        x0 = a.cap * tanhf(x0 / a.cap);
        x1 = a.cap * tanhf(x1 / a.cap);
      }
      const bool ok0 = kp0 < a.skv && (!a.causal || kp0 <= qpos) &&
                       (!a.window || kp0 > qpos - a.window);
      const bool ok1 = kp1 < a.skv && (!a.causal || kp1 <= qpos) &&
                       (!a.window || kp1 > qpos - a.window);
      x0 = ok0 ? x0 : kNegInf;
      x1 = ok1 ? x1 : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[r][j] *= corr;
      sP[row * kBK + lane] = p0;
      sP[row * kBK + lane + 32] = p1;
    }
    __syncwarp();
    // acc += P V over the tile's keys
    for (int j = 0; j < kBK; ++j) {
      float vv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) vv[e] = sV[j * D + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float p = sP[(warp * RW + r) * kBK + j];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int s = q_start + warp * RW + r;
    if (s < a.sq) {
      const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int e = 0; e < DL; ++e)
        ob[s * a.os[2] + lane + 32 * e] = from_f<T>(acc[r][e] / denom);
      if (a.lse != nullptr && lane == 0)  // m and l are the warp's, lane-uniform
        a.lse[(static_cast<long long>(b) * a.hq + h) * a.sq + s] =
            m[r] + logf(denom);
    }
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = allow_smem(flash_attention_kernel<T, D>, bytes, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + block_q<D>() - 1) / block_q<D>(), a.hq, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const FlashArgs& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    case 256: return launch<T, 256>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// -- bf16 at D 256: wgmma on the tensor cores, cp.async loads ----------------

constexpr int kWBQ = 64;   // query rows a block: the M of one wgmma
constexpr int kWBK = 64;   // keys a tile
constexpr int kStages = 2; // K / V ring depth (a third measured no faster)

template <int D, int NWG>
constexpr size_t wgmma_smem_bytes() {
  // 1 KB of slack to align the tiles to the swizzle's 1024-byte period
  return 1024 + 2 * (NWG * kWBQ * D + kStages * 2 * kWBK * D);
}

// The accumulator fragment (wgmma.cuh) gives a thread two query rows, and
// the four lanes of a quad hold the whole of each.
//
// NWG warpgroups a block take NWG query heads of one kv head (h =
// blockIdx.y * NWG + warpgroup), the same 64 query positions each, and
// share every K / V tile: NWG = 2 halves the tile traffic from L2 per
// query row.
template <int D, int NWG>
__global__ void __launch_bounds__(kThreads * NWG, 1)
    flash_attention_wgmma_kernel(const FlashArgs a) {
  constexpr int NT = kThreads * NWG;
  constexpr int NP = D / 64;                    // 64-column panels of O
  constexpr uint32_t Q_BYTES = kWBQ * D * 2;
  constexpr uint32_t T_BYTES = kWBK * D * 2;    // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const uint32_t s_q = base + wg * Q_BYTES;     // this warpgroup's Q
  const uint32_t s_kv = base + NWG * Q_BYTES;   // stage st: K, then V

  // the last query tiles see the most keys under a causal mask: they are
  // scheduled first, so the short ones fill in behind them
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kWBQ;
  const int h = blockIdx.y * NWG + wg, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int warp = tid >> 5, lane = tid & 31;
  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];

  // the band of keys any row of this block can see
  const int q_last = min(q_start + kWBQ, a.sq) - 1;
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = a.window ? max(0, q_start - a.window + 1) : 0;
  k_begin = (k_begin / kWBK) * kWBK;
  const int n_tiles = (k_end - k_begin + kWBK - 1) / kWBK;

  // tile j of the band into ring stage j % kStages, one commit group each
  // (empty past the band, so that the count of groups stays uniform)
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = s_kv + (j % kStages) * 2 * T_BYTES;
      const int kn = k_begin + j * kWBK;
      load_tile<D, kWBK, NT>(st, kb + kn * a.ks[2], a.ks[2], a.skv - kn,
                             threadIdx.x);
      load_tile<D, kWBK, NT>(st + T_BYTES, vb + kn * a.vs[2], a.vs[2],
                             a.skv - kn, threadIdx.x);
    }
    cp_async_commit();
  };
  load_tile<D, kWBQ, kThreads>(s_q, qb + q_start * a.qs[2], a.qs[2],
                               a.sq - q_start, tid);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  const float scale_log2 = a.scale * kLog2e;
  // this thread's two query rows
  const int r0 = 16 * warp + (lane >> 2);
  const int qpos0 = q_start + r0, qpos1 = qpos0 + 8;
  float o[NP][32], s[32];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kWBK;
    // tile t has landed (kStages - 2 younger groups may still be in
    // flight), and every thread is done with tile t - 1, whose stage the
    // load of tile t + kStages - 1 overwrites; the async proxy (wgmma) must
    // see what cp.async wrote
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    load_kv(t + kStages - 1);
    const uint32_t s_k = s_kv + (t % kStages) * 2 * T_BYTES;
    const uint32_t s_v = s_k + T_BYTES;

    // S = Q K^T over D in steps of 16 (32 bytes along the swizzled row)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) << 5;   // 16 bf16 = 32 bytes
      wgmma_ss(s,
               desc_b128(s_q + (kk >> 2) * kWBQ * 128 + off, 16, 1024),
               desc_b128(s_k + (kk >> 2) * kWBK * 128 + off, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // masks only where the tile crosses the diagonal, the window's edge or
    // the end of the keys
    const bool masked = k0 + kWBK > a.skv ||
                        (a.causal && k0 + kWBK - 1 > q_start) ||
                        (a.window && k0 <= q_start + kWBQ - 1 - a.window);
    // scores in the log2 domain (x log2 e), so that p = 2^(x - m) is one
    // ex2; NEG_INF stays the finite sentinel of the fp32 softmax. The
    // branches are uniform and sit outside the element loops: inside, the
    // compiler predicates them and every element pays for the cap's tanh
    // and the masks whether they apply or not.
    if (a.cap != 0.0f) {
      const float inner = a.scale / a.cap, outer = a.cap * kLog2e;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = outer * tanh_fast(s[i] * inner);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    }
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = (i & 2) ? qpos1 : qpos0;
        const bool ok = kp < a.skv && (!a.causal || kp <= qp) &&
                        (!a.window || kp > qp - a.window);
        s[i] = ok ? s[i] : kNegInf;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, off));
    }
    const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // p in fp32 for l; rounded to bf16 pairs as P V's A fragments: the
    // accumulator's columns 16 kk .. 16 kk + 15 are fragment kk's
    uint32_t pa[kWBK / 16][4];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        p[e] = ex2(s[i] - ((i & 2) ? m1 : m0));
        if (i & 2) ps1 += p[e];
        else ps0 += p[e];
      }
      pa[kk][0] = pack_bf16(p[0], p[1]);   // row r0, columns 0-7 of 16
      pa[kk][1] = pack_bf16(p[2], p[3]);   // row r0 + 8
      pa[kk][2] = pack_bf16(p[4], p[5]);   // row r0, columns 8-15
      pa[kk][3] = pack_bf16(p[6], p[7]);   // row r0 + 8
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= (i & 2) ? c1 : c0;

    // O += P V: keys in steps of 16 (16 rows of 128 bytes), D in panels
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        wgmma_rs(o[j], pa[kk],
                 desc_b128(s_v + j * kWBK * 128 + kk * 16 * 128,
                           kWBK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NP; ++j) fence_regs(o[j]);
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFullMask, l0, off);
    l1 += __shfl_xor_sync(kFullMask, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-20f), inv1 = 1.0f / fmaxf(l1, 1e-20f);
  // m is in the log2 domain (scores x log2 e): lse = m ln 2 + log(l), each
  // row written by the first lane of its quad
  if (a.lse != nullptr && (lane & 3) == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = a.lse + (static_cast<long long>(b) * a.hq + h) * a.sq;
    if (qpos0 < a.sq) lb[qpos0] = m0 * kLn2 + logf(fmaxf(l0, 1e-20f));
    if (qpos1 < a.sq) lb[qpos1] = m1 * kLn2 + logf(fmaxf(l1, 1e-20f));
  }
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int qp = (i & 2) ? qpos1 : qpos0;
      if (qp < a.sq) {
        const int col = 64 * j + 8 * (i >> 2) + 2 * (lane & 3);
        const float inv = (i & 2) ? inv1 : inv0;
        *reinterpret_cast<__nv_bfloat162*>(ob + qp * a.os[2] + col) =
            __floats2bfloat162_rn(o[j][i] * inv, o[j][i + 1] * inv);
      }
    }
}

template <int D, int NWG>
int launch_wgmma(const FlashArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t bytes = wgmma_smem_bytes<D, NWG>();
  cudaError_t err = allow_smem(flash_attention_wgmma_kernel<D, NWG>, bytes,
                               smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kWBQ - 1) / kWBQ, a.hq / NWG, batch);
  flash_attention_wgmma_kernel<D, NWG>
      <<<grid, kThreads * NWG, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Two warpgroups a block (two query heads sharing each K / V tile) from
// 128 blocks on: one block fills an SM's shared memory at D 256, so
// gemma2's 16 / 8 heads at 1024 tokens run one wave of 128 blocks, not
// two of 128 and 128.
int launch_wgmma_256(const FlashArgs& a, int batch, cudaStream_t stream) {
  const long long nq = (a.sq + kWBQ - 1) / kWBQ;
  if ((a.hq / a.hkv) % 2 == 0 && nq * (a.hq / 2) * batch >= 128)
    return launch_wgmma<256, 2>(a, batch, stream);
  return launch_wgmma<256, 1>(a, batch, stream);
}


// -- bf16 at D 64 and 128: warp-specialised, TMA-fed, ping-pong --------------

constexpr int kWsRows = 128;     // query rows a unit: two consumers of 64
constexpr int kWsKeys = 128;     // keys a tile
constexpr int kWsThreads = 384;  // the producer warpgroup, two consumers
// setmaxnreg: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536 registers
// (the launch gives every thread 65,536 / 384 rounded down to 8: 168)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int D>
__host__ __device__ constexpr int ws_stages() {
  return D == 64 ? 4 : 2;
}

template <int D>
constexpr size_t ws_smem_bytes() {
  // 1 KB of slack to align the tiles to the swizzle's 1024-byte period, two
  // Q slots, the K and V rings, then two barriers a Q slot and four a stage
  return 1024 + 2 * (2 * kWsRows * D) + ws_stages<D>() * 2 * (2 * kWsKeys * D) +
         8 * (4 + 4 * ws_stages<D>());
}

// A unit of work: 128 query rows of one (batch, head), and the band of key
// tiles any of its rows can see.
struct WsUnit {
  int q_start, h, b, k_begin, n_tiles;
};

// Unit u, numbered longest first: the last query tiles (the most keys
// under a causal mask) of every (batch, head), then the tiles before them.
__device__ __forceinline__ WsUnit ws_unit(const FlashArgs& a, int nq, int u) {
  const int heads = a.hq * a.batch;
  WsUnit w;
  w.q_start = (nq - 1 - u / heads) * kWsRows;
  w.b = (u % heads) / a.hq;
  w.h = u % a.hq;
  const int q_last = min(w.q_start + kWsRows, a.sq) - 1;
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = a.window ? max(0, w.q_start - a.window + 1) : 0;
  w.k_begin = (k_begin / kWsKeys) * kWsKeys;
  w.n_tiles = max(0, (k_end - w.k_begin + kWsKeys - 1) / kWsKeys);
  return w;
}

// The block's i-th unit, or one past the last: block g of G takes units
// g, 2G - 1 - g, 2G + g, 4G - 1 - g, ..., so that long and short units
// alternate and the blocks' sums of keys come out about even.
__device__ __forceinline__ int ws_unit_index(int i) {
  return i * gridDim.x +
         ((i & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// tm_q, tm_k, tm_v: q, k, v as [B][H][S][D] maps, boxes of [128 rows][64]
// (kernels/flash_attention.py's tma_map_geometry). Persistent: one block
// an SM walks its units (ws_unit_index); the producer runs ahead across
// units, so one unit's last products and stores overlap the next one's
// loads.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_attention_ws_kernel(const FlashArgs a,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v) {
  constexpr int S = ws_stages<D>();
  constexpr int NP = D / 64;                      // 64-column panels
  constexpr uint32_t Q_BYTES = kWsRows * D * 2;
  constexpr uint32_t T_BYTES = kWsKeys * D * 2;   // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;                      // slot qs at qs Q_BYTES
  const uint32_t s_k = s_q + 2 * Q_BYTES;         // stage st at st T_BYTES
  const uint32_t s_v = s_k + S * T_BYTES;
  const uint32_t bars = s_v + S * T_BYTES;
  // Q slot qs: full, empty; ring stage st by kind: 0 K full, 1 V full,
  // 2 K empty, 3 V empty. A Q slot or stage is filled once a round: the
  // n-th filling's barriers complete phase n, of parity n & 1.
  const auto q_full = [bars](int qs) { return bars + 8 * qs; };
  const auto q_empty = [bars](int qs) { return bars + 8 * (2 + qs); };
  const auto bar = [bars](int kind, int st) {
    return bars + 8 * (4 + kind * S + st);
  };
  const int nq = (a.sq + kWsRows - 1) / kWsRows;
  const int n_units = nq * a.hq * a.batch;

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < 2; ++qs) {
      mbar_init(q_full(qs), 1);
      mbar_init(q_empty(qs), 8);  // one arrival from each consumer warp
    }
    for (int st = 0; st < S; ++st) {
      mbar_init(bar(0, st), 1);
      mbar_init(bar(1, st), 1);
      mbar_init(bar(2, st), 8);
      mbar_init(bar(3, st), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, through a shuffle so that the compiler sees it uniform
  // and gives each role's code the registers setmaxnreg leaves it
  const int wg = __shfl_sync(kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // The producer warpgroup: one thread keeps the Q slots and the rings
    // full, the others leave once the warpgroup has handed its registers
    // on.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int kv = 0, qn = 0;   // K (and V) tiles, Q tiles loaded so far
      for (int i = 0;; ++i) {
        const int u = ws_unit_index(i);
        if (u >= n_units) break;
        const WsUnit w = ws_unit(a, nq, u);
        if (w.n_tiles == 0) continue;
        const int hk = w.h / (a.hq / a.hkv);
        const int qs = qn & 1;
        mbar_wait(q_empty(qs), ((qn >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qs), Q_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(s_q + qs * Q_BYTES + p * kWsRows * 128, tm_q, 64 * p,
                   w.q_start, w.h, w.b, q_full(qs));
        ++qn;
        // the unit's tile j of K (kind 0) or V (kind 1), the block's
        // n = kv + j-th, into stage n % S once both consumers have
        // released the tile S before it (a fresh barrier passes a wait on
        // parity 1)
        const auto load = [&](const CUtensorMap& map, int kind, int j) {
          const int n = kv + j, st = n % S;
          mbar_wait(bar(2 + kind, st), ((n / S) & 1) ^ 1);
          const uint32_t full = bar(kind, st);
          mbar_expect_tx(full, T_BYTES);
          const uint32_t dst = (kind ? s_v : s_k) + st * T_BYTES;
#pragma unroll
          for (int p = 0; p < NP; ++p)
            tma_load(dst + p * kWsKeys * 128, map, 64 * p,
                     w.k_begin + j * kWsKeys, hk, w.b, full);
        };
        // K runs a tile ahead of V, in the order the consumers take them
        load(tm_k, 0, 0);
        for (int j = 1; j < w.n_tiles; ++j) {
          load(tm_k, 0, j);
          load(tm_v, 1, j - 1);
        }
        load(tm_v, 1, w.n_tiles - 1);
        kv += w.n_tiles;
      }
    }
    return;
  }

  // The consumers: warpgroup cw owns a unit's rows q_wg .. q_wg + 63.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  using bf16 = __nv_bfloat16;
  const float scale_log2 = a.scale * kLog2e;
  const int r0 = 16 * warp + (lane >> 2);   // this thread's rows r0, r0 + 8
  float o[D / 2], s[64];
  uint32_t pa[kWsKeys / 16][4];
  float m0, m1, l0, l1;
  float c0 = 1.0f, c1 = 1.0f;   // the last softmax's rescale of O
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;
  int kv = 0, qn = 0;           // as the producer's counts
  uint32_t s_qw = 0;            // the unit's Q slot, this warpgroup's rows
  WsUnit w{};
  int q_wg = 0;

  // S = Q K_n^T over D in steps of 16 (32 bytes along the swizzled row)
  const auto issue_s = [&](int n) {
    const uint32_t sk = s_k + (n % S) * T_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) << 5;
      wgmma_ss_n128(s,
                    desc_b128(s_qw + (kk >> 2) * kWsRows * 128 + off, 16,
                              1024),
                    desc_b128(sk + (kk >> 2) * kWsKeys * 128 + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_n: keys in steps of 16 (16 rows of 128 bytes), all of D in
  // one product (at D 128 its two panels lie LBO apart)
  const auto issue_pv = [&](int n) {
    const uint32_t sv = s_v + (n % S) * T_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWsKeys / 16; ++kk) {
      const uint64_t dv = desc_b128(sv + kk * 16 * 128, kWsKeys * 128, 1024);
      if constexpr (D == 128) wgmma_rs_n128(o, pa[kk], dv);
      else wgmma_rs(o, pa[kk], dv);
    }
    wgmma_commit();
  };
  // one arrival a warp, after the warp's wait
  const auto release = [&](uint32_t barrier) {
    if (lane == 0) mbar_arrive(barrier);
  };
  // The online softmax of the unit's tile t on S, in place: scores in the
  // log2 domain (x log2 e), so that p = 2^(x - m) is one ex2; NEG_INF stays
  // the finite sentinel of the fp32 softmax. The branches are uniform and
  // sit outside the element loops: inside, the compiler predicates them
  // and every element pays for the cap's tanh and the masks whether they
  // apply or not. Masks only where the tile crosses the diagonal, the
  // window's edge or the end of the keys. Sets c to O's rescale and adds p
  // to l.
  const auto softmax = [&](int t) {
    const int k0 = w.k_begin + t * kWsKeys;
    const int qpos0 = q_wg + r0, qpos1 = qpos0 + 8;
    const bool masked = k0 + kWsKeys > a.skv ||
                        (a.causal && k0 + kWsKeys - 1 > q_wg) ||
                        (a.window && k0 <= q_wg + 63 - a.window);
    if (a.cap != 0.0f) {
      const float inner = a.scale / a.cap, outer = a.cap * kLog2e;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = outer * tanh_fast(s[i] * inner);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
    }
    if (masked) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = (i & 2) ? qpos1 : qpos0;
        const bool ok = kp < a.skv && (!a.causal || kp <= qp) &&
                        (!a.window || kp > qp - a.window);
        s[i] = ok ? s[i] : kNegInf;
      }
    }
    // Row maxima and sums in four chains a row, combined as a tree: with
    // two consumer warps an SM sub-partition, a chain of 32 dependent ops
    // would wait out each one's latency. (The max is the same in any
    // order; the sum's order is the kernel's own.)
    float mx[2][4], ps[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0][j] = mx[1][j] = kNegInf;
      ps[0][j] = ps[1][j] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float& x = mx[(i >> 1) & 1][(i >> 2) & 3];
      x = fmaxf(x, s[i]);
    }
    float mx0 = fmaxf(m0, fmaxf(fmaxf(mx[0][0], mx[0][1]),
                                fmaxf(mx[0][2], mx[0][3])));
    float mx1 = fmaxf(m1, fmaxf(fmaxf(mx[1][0], mx[1][1]),
                                fmaxf(mx[1][2], mx[1][3])));
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, off));
    }
    c0 = ex2(m0 - mx0);
    c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = ex2(s[i] - ((i & 2) ? m1 : m0));
      ps[(i >> 1) & 1][(i >> 2) & 3] += s[i];
    }
    l0 = l0 * c0 + ((ps[0][0] + ps[0][1]) + (ps[0][2] + ps[0][3]));
    l1 = l1 * c1 + ((ps[1][0] + ps[1][1]) + (ps[1][2] + ps[1][3]));
  };
  // p rounded to bf16 pairs as P V's A fragments: S's columns 16 kk ..
  // 16 kk + 15 are fragment kk's
  const auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < kWsKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);      // row r0
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row r0 + 8
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // r0, cols + 8
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // r0 + 8
    }
  };
  // O's rescale for the last softmax, left out where no row of the warp
  // moved its max (c is exactly 1 there, and o * 1 is o bit for bit)
  const auto rescale = [&] {
    if (__all_sync(kFullMask, c0 == 1.0f && c1 == 1.0f)) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? c1 : c0;
  };
  // after a wait: the registers an in-flight product used may not be
  // reused, nor their reads moved, above it
  const auto pin_o_p = [&] {
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kWsKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
  };

  // Ping-pong: consumer cw issues its products between a sync on named
  // barrier 1 + cw and an arrival on the other's, so the two consumers'
  // products take turns on the tensor cores and each one's softmax runs
  // under the other's products. Consumer 1 lets consumer 0 go first; both
  // make n + 1 such steps a unit, and consumer 1's last arrival, which no
  // sync would meet, is left out.
  const int my_bar = 1 + cw, other_bar = 2 - cw;
  if (cw == 1) named_arrive(other_bar, 256);
  for (int i = 0;; ++i) {
    const int u = ws_unit_index(i);
    if (u >= n_units) break;
    const bool last_unit = ws_unit_index(i + 1) >= n_units;
    w = ws_unit(a, (a.sq + kWsRows - 1) / kWsRows, u);
    q_wg = w.q_start + 64 * cw;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
    const int n_tiles = w.n_tiles;
    if (n_tiles > 0) {
      const int qs = qn & 1;
      s_qw = s_q + qs * Q_BYTES + cw * 64 * 128;
      mbar_wait(q_full(qs), (qn >> 1) & 1);
      mbar_wait(bar(0, kv % S), (kv / S) & 1);
      named_sync(my_bar, 256);
      issue_s(kv);
      named_arrive(other_bar, 256);
      wgmma_wait<0>();
      fence_regs(s);
      release(bar(2, kv % S));
      if (n_tiles == 1) release(q_empty(qs));
      softmax(0);
      pack();
      // Tile t's S is issued before the products of tile t - 1 and waited
      // for first, so its softmax runs while P V of tile t - 1 is in
      // flight (FlashAttention-3's intra-warpgroup overlap).
      for (int t = 1; t < n_tiles; ++t) {
        const int n = kv + t;
        mbar_wait(bar(0, n % S), (n / S) & 1);
        named_sync(my_bar, 256);
        issue_s(n);
        rescale();
        mbar_wait(bar(1, (n - 1) % S), ((n - 1) / S) & 1);
        issue_pv(n - 1);
        named_arrive(other_bar, 256);
        wgmma_wait<1>();
        fence_regs(s);
        release(bar(2, n % S));
        if (t == n_tiles - 1) release(q_empty(qs));
        softmax(t);
        wgmma_wait<0>();
        pin_o_p();
        release(bar(3, (n - 1) % S));
        pack();
      }
      const int n = kv + n_tiles - 1;
      rescale();
      mbar_wait(bar(1, n % S), (n / S) & 1);
      named_sync(my_bar, 256);
      issue_pv(n);
      if (cw == 0 || !last_unit) named_arrive(other_bar, 256);
      wgmma_wait<0>();
      pin_o_p();
      release(bar(3, n % S));
      kv += n_tiles;
      ++qn;
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(kFullMask, l0, off);
      l1 += __shfl_xor_sync(kFullMask, l1, off);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-20f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-20f);
    const int qpos0 = q_wg + r0, qpos1 = qpos0 + 8;
    // m is in the log2 domain (scores x log2 e): lse = m ln 2 + log(l),
    // each row written by the first lane of its quad
    if (a.lse != nullptr && (lane & 3) == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lb = a.lse + (static_cast<long long>(w.b) * a.hq + w.h) * a.sq;
      if (qpos0 < a.sq) lb[qpos0] = m0 * kLn2 + logf(fmaxf(l0, 1e-20f));
      if (qpos1 < a.sq) lb[qpos1] = m1 * kLn2 + logf(fmaxf(l1, 1e-20f));
    }
    bf16* ob = static_cast<bf16*>(a.o) + w.b * a.os[0] + w.h * a.os[1];
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int qp = (j & 2) ? qpos1 : qpos0;
      if (qp < a.sq) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3);
        const float inv = (j & 2) ? inv1 : inv0;
        *reinterpret_cast<__nv_bfloat162*>(ob + qp * a.os[2] + col) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
      }
    }
  }
}

// maps: q's, k's and v's geometry, 11 values each: dims (D, S, H, B), byte
// strides of S, H and B, box (64, 128, 1, 1). One block an SM, or one a
// unit where there are fewer units.
template <int D>
int launch_ws(const FlashArgs& a, const long long* maps,
              cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t bytes = ws_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_attention_ws_kernel<D>, bytes, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (maps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // The maps this thread last encoded for q, k and v, reused while a
  // tensor keeps its address and geometry (the serving engine's buffers):
  // encoding is host work on every call, and the short calls are
  // host-bound. Per thread, so concurrent callers never share one.
  struct Encoded {
    const void* base = nullptr;
    long long geometry[11] = {};
    CUtensorMap map;
  };
  static thread_local Encoded last[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    const long long* g = maps + 11 * i;
    if (g[0] != D || g[7] != 64 || g[8] != kWsRows || g[9] != 1 ||
        g[10] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if (last[i].base == ptrs[i] &&
        std::equal(g, g + 11, last[i].geometry))
      continue;
    last[i].base = nullptr;
    if (!encode_tma_map(&last[i].map, ptrs[i], g, g + 4, g + 7))
      return static_cast<int>(cudaErrorInvalidValue);
    last[i].base = ptrs[i];
    std::copy(g, g + 11, last[i].geometry);
  }
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static thread_local int sm_count[64] = {};   // by device ordinal
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sm_count[device];
  const long long units = static_cast<long long>(
      (a.sq + kWsRows - 1) / kWsRows) * a.hq * a.batch;
  const int grid = static_cast<int>(units < sms ? units : sms);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  flash_attention_ws_kernel<D><<<grid, kWsThreads, bytes, stream>>>(
      a, last[0].map, last[1].map, last[2].map);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const FlashArgs& a, int batch, int d, const long long* maps,
                cudaStream_t stream) {
  switch (d) {
    case 64: return launch_ws<64>(a, maps, stream);
    case 128: return launch_ws<128>(a, maps, stream);
    case 256: return launch_wgmma_256(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dims: b, hq, hkv, sq, skv, d; strides: q, k, v, o as (b, h, s) each;
// lse: [B, Hq, Sq] fp32 or nullptr; maps: the TMA geometry of q, k and v
// for bf16 at D 64 and 128 (launch_ws), else nullptr.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    void* lse, const long long* dims, const long long* strides,
                    const long long* maps, int is_bf16, int causal,
                    int window, float cap, float scale, void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
  a.hq = static_cast<int>(dims[1]);
  a.hkv = static_cast<int>(dims[2]);
  a.sq = static_cast<int>(dims[3]);
  a.skv = static_cast<int>(dims[4]);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.causal = causal; a.window = window; a.cap = cap; a.scale = scale;
  const int batch = static_cast<int>(dims[0]), d = static_cast<int>(dims[5]);
  a.batch = batch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(a, batch, d, maps, s)
                 : launch_d<float>(a, batch, d, s);
}

}  // extern "C"
