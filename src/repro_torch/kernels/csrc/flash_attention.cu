// Forward flash attention for Hopper (sm_90a): GQA, causal mask, sliding
// window (kpos > qpos - window), softcap cap * tanh(s / cap), fp32 online
// softmax with NEG_INF = -2^30, fp32 accumulation, fp32 or bf16 storage.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, pallas_call at :103). The TPU kernel walks a
// sequential kv grid axis and carries m, l and the accumulator in VMEM
// scratch; here one block owns a tile of query rows of one (batch, head)
// and loops over the kv tiles itself, so nothing is carried between
// blocks. Grid: (ceil(Sq / rows), Hq / heads a block, B); query head h
// reads kv head h / (Hq / Hkv). The tiles that lie wholly outside the causal / window
// band of the block's rows are never loaded: the loop runs from the first
// tile with k_end > q_start - window to the last with k_start <= q_end,
// the TPU kernel's skip.
//
// Bound: the live FLOPs (4 * D per unmasked (q, k) pair and head) at the
// tensor cores' rate against the bytes (q, k, v, o once each); for
// granite's heads (32/8, D 64) the bytes bound below ~740 tokens and the
// operations above. Two kernels, picked by the storage type:
//
// * bf16 (every served model): `flash_attention_wgmma_kernel`, both
//   products on the tensor cores with `wgmma`. One warpgroup (128
//   threads) owns 64 query rows, the M of one wgmma. S = Q K^T reads Q and
//   the K tile from shared memory (both K-major: D contiguous); O += P V
//   takes P from registers as the A operand and the V tile [keys, D] from
//   shared memory as an MN-major B (the descriptor's transpose bit). Both
//   accumulate in fp32; every product is an m64n64k16 (O at D > 64 is
//   D / 64 such column panels). Shared tiles are stored in the 128-byte
//   swizzle that the descriptors name ([D / 64 panels][rows][64], 16-byte
//   chunk c of row r at c ^ (r % 8)), so the layout is one for Q, K and V.
//   K and V tiles of 64 keys come in by cp.async, 16 bytes a thread, into
//   a ring of two stages: the next tile's load is in flight during this
//   tile's products, one barrier a tile. Interior tiles of the causal /
//   window band run without masks; only the diagonal tile, the window's
//   edge tile and the ragged last tile are masked, on the S accumulator
//   fragment.
//   The softmax runs in the log2 domain on `ex2.approx` (one MUFU op, a
//   couple of ulps), the softcap's tanh built from it; the cap and mask
//   branches are uniform and sit outside the per-element loops, where
//   predication would make every element pay for them.
//   P is rounded to bf16 before P V, as FlashAttention-2/3 do (the TPU's
//   MXU is fed bf16 the same way at default precision); l sums the fp32
//   p. Against the plain version (fp32 P) that costs at most about 2^-9
//   relative per product, well inside the bf16 tolerance (2e-2); the
//   chip rows of PERF.md give the max-abs it reads at the served shapes.
//   Tiles: 64 query rows a warpgroup and 64 keys a tile at every D, and
//   one or two warpgroups a block (launch_wgmma_d): two take two query
//   heads of one kv head and share each K / V tile, halving the tile
//   traffic from L2 and giving an SM two warpgroups at D 256 (where one
//   block fills its shared memory); one keeps more blocks where the grid
//   is small. At B = 1 and
//   32 heads the 256 bucket gives 4 x 32 = 128 blocks of one warpgroup
//   (132 SMs), 512 gives 256, and 1024 gives 256 blocks of two. Shared
//   memory: 41 / 49 KB at D 64 (one / two warpgroups), 81 / 97 KB at D 128,
//   161 / 193 KB at D 256 (one block an SM there). Registers: O is D / 2
//   fp32 a thread (128 at D 256), S 32, P 16 packed words;
//   __launch_bounds__(128 * warpgroups, 1) leaves the compiler 255.
//   Order: blocks run the last query tiles (the most keys under a causal
//   mask) first.
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
// both read without a copy. The bf16 kernel needs 16-byte aligned rows
// (the wrapper checks).
//
// Optionally (lse != nullptr, the training path's forward) both kernels
// also write each row's log-sum-exp, lse = m + log(max(l, 1e-20)) in fp32
// ([B, Hq, Sq] contiguous), as src/repro/models/flash_vjp.py's forward
// returns it for its backward (csrc/flash_attention_bwd.cu). It is written
// after the output and touches none of its arithmetic, so o is the same
// with or without it.

#include "common.cuh"
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
  int hq, hkv, sq, skv;
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


// -- bf16: wgmma on the tensor cores -----------------------------------------

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

// Two warpgroups a block (two query heads sharing each K / V tile) where
// the group size allows it and the grid still has kMinBlocks blocks;
// otherwise one, for more blocks. D 64 and 128 fit 2-4 blocks an SM, so
// they ask for 256 blocks: at B = 1, 32 / 8 heads, D 64 the 256 and 512
// buckets keep one warpgroup (128 and 256 blocks), 1024 takes two (256
// blocks). At D 256 one block fills an SM's shared memory, so two
// warpgroups a block are taken from 128 blocks on (gemma2's 16 / 8 heads
// at 1024 tokens: one wave of 128 blocks, not two of 128 and 128).
template <int D>
int launch_wgmma_d(const FlashArgs& a, int batch, cudaStream_t stream) {
  constexpr long long kMinBlocks = D == 256 ? 128 : 256;
  const long long nq = (a.sq + kWBQ - 1) / kWBQ;
  if ((a.hq / a.hkv) % 2 == 0 && nq * (a.hq / 2) * batch >= kMinBlocks)
    return launch_wgmma<D, 2>(a, batch, stream);
  return launch_wgmma<D, 1>(a, batch, stream);
}

int launch_bf16(const FlashArgs& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_wgmma_d<64>(a, batch, stream);
    case 128: return launch_wgmma_d<128>(a, batch, stream);
    case 256: return launch_wgmma_d<256>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dims: b, hq, hkv, sq, skv, d; strides: q, k, v, o as (b, h, s) each;
// lse: [B, Hq, Sq] fp32 or nullptr.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    void* lse, const long long* dims, const long long* strides,
                    int is_bf16, int causal, int window, float cap,
                    float scale, void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(a, batch, d, s) : launch_d<float>(a, batch, d, s);
}

}  // extern "C"
