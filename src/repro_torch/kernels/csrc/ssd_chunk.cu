// The Mamba2 SSD step inside one chunk for Hopper (sm_90a), per (batch,
// head): with a = cumsum(dt * A) over the chunk (A = -exp(a_log)),
//   L[s, r] = exp(a_s - a_r) for r <= s, 0 above the diagonal (masked
//             BEFORE the exp, NEG = -1e30, as the TPU kernel);
//   y       = (C B^T ∘ L) (dt ∘ X)                      [Q, P], x's type
//   state   = ((exp(a_Q - a_r) ∘ B)^T (dt ∘ X))          [N, P], fp32
//   decay   = exp(a_Q)                                          fp32
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py
// (`ssd_chunk`, pallas_call at :57), grid (B, H) as there: one block a
// (batch row, head). The wrapper passes every chunk of a sequence as a
// batch row of one call, so a 512-token sequence of mamba2 is one launch
// of 4 x 24 blocks.
//
// Bound: bytes at the served sizes (mamba2's chunk: 1.65 MB in and out
// against 78 MFLOP at the tensor cores' rate). The live work is
// Q(Q+1)/2 * N MACs for the scores per batch row, and per head
// Q(Q+1)/2 * P for y and Q * N * P for the state. Two kernels, picked by
// the storage type:
//
// * bf16 (every served model): `ssd_chunk_wgmma_kernel`, the three
//   products on the tensor cores with m64n64k16 `wgmma` (wgmma.cuh), fp32
//   accumulation. One warpgroup owns 64 query rows (Q <= 256, so up to 4
//   warpgroups a block); P <= 64 (the served heads are 64 wide). C, B and X come in once by TMA, a box of 64
//   columns a panel, into 128-byte-swizzled tiles ([cols / 64 panels][Q
//   rows][64]), zero-filled past Q rows and past N or P columns, so that
//   P 32 or N 16 pad to one 64-column panel and a ragged Q to whole 64-row
//   tiles. (The first version's 16-byte cp.async copies, 20 a thread at
//   mamba2's chunk, were bound by their issue: zero-filled ones took as
//   long as the others.)
//   - Scores: S = C B^T with C and B K-major (K = N, only its 16-column
//     steps that hold data), one 64-column tile r at a time and only the
//     tiles at or below the warpgroup's diagonal.
//   - y: dt folds into S's columns, so X reaches the tensor cores as it
//     is stored: S' = S ∘ L ∘ dt_r (the mask a select on the diagonal
//     tile, L by ex2 of the log2-domain cumsum) is rounded to bf16 and is
//     the register A operand of y += S' X; S's columns 16 kk .. 16 kk + 15
//     are the A fragment kk, and X is the MN-major B operand. Only S' is
//     rounded (the plain version keeps dt ∘ X in fp32).
//   - State: w_r = exp(a_Q - a_r) dt_r scales X's rows into bf16 w ∘ X
//     (the state's only rounding) before the products start; then
//     state = B^T (w ∘ X) with both operands MN-major from shared memory,
//     M = N in 64-row tiles, taken by the first half of the warpgroups
//     (those with the fewest score tiles), so no barrier waits for y.
//   - The cumulative sum is one warp's: each lane sums QP / 32 consecutive
//     rows in order, then an exclusive shuffle scan adds the lanes before
//     it (an order other than the plain version's sequential one).
//   No atomics: the same inputs give the same bits.
//   Shared memory: 4 Q' (N' + 64) bytes + 1 KB of alignment (Q', N' Q and
//   N rounded up to 64), 99 KB at mamba2's Q 128, N 128, P 64: two blocks
//   of 256 threads an SM.
// * fp32: `ssd_chunk_kernel`, the CUDA-core kernel of the first port. The
//   TPU holds the whole chunk in VMEM; a Hopper block has at most 227 KB of
//   shared memory, and fp32 B and C tiles of [128, 128] (64 KB each) with
//   the [Q, Q] scores (64 KB) and X (32 KB) would not leave room. So only
//   the scores [Q][Q+1] and dt ∘ X [Q][P] stay resident in fp32 (dynamic
//   shared memory, 130.5 KB at Q = 128, P = 64), and B and C pass through
//   in 32-column slices, accumulated into the scores, then B again, scaled
//   by its decay, for the state. The cumulative sum is taken sequentially,
//   in the reference's order.
//
// Inputs are addressed by strides (elements; the last dim contiguous), so
// the model's views of one [B, S, d_inner + 2N] tensor are read in place.
// The bf16 kernel needs 16-byte aligned rows (the wrapper checks).

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro_kernels;

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kNC = 32;  // B / C columns per slice
constexpr size_t kMaxSmem = 232448;  // a Hopper block's dynamic maximum

struct SsdArgs {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* a_log;
  void* y;
  float* state;  // [B, H, N, P]
  float* decay;  // [B, H]
  int q, h, n, p;
  long long xs[3];   // x strides of (b, s, h)
  long long bs[2];   // b strides of (b, s)
  long long cs[2];   // c strides of (b, s)
  long long dts[3];  // dt strides of (b, s, h)
  long long ys[3];   // y strides of (b, s, h)
};

size_t smem_bytes(int q, int p) {
  return sizeof(float) *
         (static_cast<size_t>(q) * (q + 1) + static_cast<size_t>(q) * p +
          2 * static_cast<size_t>(q) * (kNC + 1) + 2 * static_cast<size_t>(q));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const SsdArgs a) {
  extern __shared__ float sm[];
  const int Q = a.q, N = a.n, P = a.p, QP = Q + 1, CP = kNC + 1;
  float* sS = sm;              // [Q][Q+1] scores
  float* sX = sS + Q * QP;     // [Q][P] dt * x
  float* sB = sX + Q * P;      // [Q][kNC + 1] slice of B
  float* sC = sB + Q * CP;     // [Q][kNC + 1] slice of C
  float* sA = sC + Q * CP;     // [Q] cumulative dt * A
  float* sDt = sA + Q;         // [Q] dt

  const int hh = blockIdx.x, bb = blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + bb * a.xs[0] + hh * a.xs[2];
  const T* bm = static_cast<const T*>(a.b) + bb * a.bs[0];
  const T* cm = static_cast<const T*>(a.c) + bb * a.cs[0];
  const float* dt = a.dt + bb * a.dts[0] + hh * a.dts[2];
  const int tid = threadIdx.x;

  for (int i = tid; i < Q; i += kThreads) sDt[i] = dt[i * a.dts[1]];
  for (int i = tid; i < Q * QP; i += kThreads) sS[i] = 0.0f;
  __syncthreads();
  if (tid == 0) {
    const float A = -expf(a.a_log[hh]);
    float run = 0.0f;
    for (int i = 0; i < Q; ++i) {
      run += sDt[i] * A;
      sA[i] = run;
    }
  }
  for (int i = tid; i < Q * P; i += kThreads) {
    const int r = i / P, pp = i - r * P;
    sX[i] = to_f(x[r * a.xs[1] + pp]) * sDt[r];
  }

  // scores[s][r] = sum_n C[s][n] B[r][n], lower triangle only
  for (int n0 = 0; n0 < N; n0 += kNC) {
    __syncthreads();
    for (int i = tid; i < Q * kNC; i += kThreads) {
      const int r = i / kNC, j = i - r * kNC, nn = n0 + j;
      const bool in = nn < N;
      sB[r * CP + j] = in ? to_f(bm[r * a.bs[1] + nn]) : 0.0f;
      sC[r * CP + j] = in ? to_f(cm[r * a.cs[1] + nn]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int s = i / Q, r = i - s * Q;
      if (r <= s) {
        float t = 0.0f;
#pragma unroll 8
        for (int j = 0; j < kNC; ++j) t = fmaf(sC[s * CP + j], sB[r * CP + j], t);
        sS[s * QP + r] += t;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Q * Q; i += kThreads) {
    const int s = i / Q, r = i - s * Q;
    sS[s * QP + r] *= expf(r <= s ? sA[s] - sA[r] : kNeg);
  }
  __syncthreads();

  // y[s][p] = sum_{r <= s} scores[s][r] * (dt x)[r][p]
  T* y = static_cast<T*>(a.y) + bb * a.ys[0] + hh * a.ys[2];
  for (int i = tid; i < Q * P; i += kThreads) {
    const int s = i / P, pp = i - s * P;
    float t = 0.0f;
    for (int r = 0; r <= s; ++r) t = fmaf(sS[s * QP + r], sX[r * P + pp], t);
    y[s * a.ys[1] + pp] = from_f<T>(t);
  }

  // state[n][p] = sum_r exp(a_Q - a_r) B[r][n] (dt x)[r][p]
  const float atot = sA[Q - 1];
  float* st = a.state + (static_cast<long long>(bb) * a.h + hh) * N * P;
  for (int n0 = 0; n0 < N; n0 += kNC) {
    __syncthreads();
    for (int i = tid; i < Q * kNC; i += kThreads) {
      const int r = i / kNC, j = i - r * kNC, nn = n0 + j;
      sB[r * CP + j] =
          nn < N ? to_f(bm[r * a.bs[1] + nn]) * expf(atot - sA[r]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < kNC * P; i += kThreads) {
      const int j = i / P, pp = i - j * P, nn = n0 + j;
      if (nn < N) {
        float t = 0.0f;
        for (int r = 0; r < Q; ++r) t = fmaf(sB[r * CP + j], sX[r * P + pp], t);
        st[nn * P + pp] = t;
      }
    }
  }
  if (tid == 0) a.decay[bb * a.h + hh] = expf(atot);
}

template <typename T>
int launch(const SsdArgs& a, int batch, cudaStream_t stream) {
  // opt in once to the whole 227 KB, so every (Q, P) that fits launches
  static bool smem_ok = false;
  const cudaError_t err = allow_smem(ssd_chunk_kernel<T>, kMaxSmem, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(a.q, a.p);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  ssd_chunk_kernel<T><<<dim3(a.h, batch), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// -- bf16: wgmma on the tensor cores -----------------------------------------

constexpr int kWG = 128;  // threads a warpgroup

__host__ __device__ constexpr int round64(int v) { return (v + 63) / 64 * 64; }

constexpr int kMaxWG = 4;   // Q <= 256: 64 query rows a warpgroup

size_t wgmma_smem_bytes(int q, int n, int p) {
  // 1 KB of slack to align the tiles to the swizzle's 1024-byte period,
  // then C, B, X and w ∘ X in bf16 (X as one 64-column panel), the cumsum
  // and dt in fp32, and the tiles' transaction barrier
  const size_t qp = round64(q);
  return 1024 + 4 * qp * (round64(n) + 64) + 2 * sizeof(float) * qp + 8;
}

// The tiles come in by TMA (tma.cuh): one thread asks for each 64-column
// panel of C, B and X as a box of [QP rows][64] bf16, which the copy
// engine writes in the 128-byte swizzle and zero-fills past Q rows and past
// N or P columns; the panels complete one transaction barrier in shared
// memory.
// tm_c, tm_b: C and B as [batch][Q][1][N] (a unit dim gives the three
// maps one rank); tm_x: X as [batch][Q][H][P]; boxes of [QP][64]
__global__ void __launch_bounds__(kWG * kMaxWG, 1)
    ssd_chunk_wgmma_kernel(const SsdArgs a,
                           const __grid_constant__ CUtensorMap tm_c,
                           const __grid_constant__ CUtensorMap tm_b,
                           const __grid_constant__ CUtensorMap tm_x) {
  using bf16 = __nv_bfloat16;
  const int Q = a.q, N = a.n, P = a.p;
  const int QP = round64(Q);       // rows padded to whole 64-row tiles
  const int NWG = QP / 64;         // warpgroups: blockDim.x / 128
  const int NPN = round64(N) / 64; // 64-column panels of B and C
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_c = base;
  const uint32_t s_b = s_c + NPN * QP * 128;
  const uint32_t s_x = s_b + NPN * QP * 128;
  const uint32_t s_wx = s_x + QP * 128;            // w ∘ X
  // per row: a2 = a log2 e (L = 2^(a2_s - a2_r)) and dt (0 past Q); then
  // the tiles' transaction barrier
  float* s_ad = reinterpret_cast<float*>(smem_raw + (s_wx + QP * 128 - raw));
  const uint32_t bar = s_wx + QP * 128 + 8 * QP;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, wg = tid / kWG;
  const int warp = (tid % kWG) >> 5, lane = tid & 31;
  const float* dt = a.dt + bb * a.dts[0] + hh * a.dts[2];

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, (2 * NPN + 1) * QP * 128);
    for (int j = 0; j < NPN; ++j) {
      tma_load(s_c + j * QP * 128, tm_c, 64 * j, 0, 0, bb, bar);
      tma_load(s_b + j * QP * 128, tm_b, 64 * j, 0, 0, bb, bar);
    }
    tma_load(s_x, tm_x, 0, hh, 0, bb, bar);
  }
  // a = cumsum(dt * A) by warp 1 (warp 0's thread 0 issues the copies)
  // while the tiles land: lane l loads its rows [l E, l E + E) of dt (0
  // past Q) together, sums them in order, then adds the exclusive shuffle
  // scan of the lanes' totals. Rows past Q add dt 0, so they all hold a_Q.
  const int E = QP / 32;
  if (tid / 32 == 1) {
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = lane * E + k;
      d[k] = k < E && r < Q ? dt[r * a.dts[1]] : 0.0f;
    }
    const float A = -expf(a.a_log[hh]);
    float run = 0.0f, part[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < E) {
        run += d[k] * A;
        part[k] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += t;
    }
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < E) {
        s_ad[2 * (lane * E + k)] = (excl + part[k]) * kLog2e;
        s_ad[2 * (lane * E + k) + 1] = d[k];
      }
    }
    if (lane == 31) a.decay[bb * a.h + hh] = expf(excl + run);
  }
  __syncthreads();        // the barrier's init before anyone waits on it
  mbar_wait(bar, 0);

  // w ∘ X for the state, w_r = exp(a_Q - a_r) dt_r, rounded to bf16 in X's
  // layout (the state's only rounding)
  const float a2_end = s_ad[2 * (QP - 1)];
  for (int i = tid; i < QP * 8; i += blockDim.x) {
    const int r = i / 8, c = i % 8;
    const uint32_t off = swz(r, c, QP);
    const float w = ex2(a2_end - s_ad[2 * r]) * s_ad[2 * r + 1];
    uint4 u = *reinterpret_cast<const uint4*>(smem_raw + (s_x + off - raw));
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      h[k] = __floats2bfloat162_rn(w * f.x, w * f.y);
    }
    *reinterpret_cast<uint4*>(smem_raw + (s_wx + off - raw)) = u;
  }
  fence_proxy_async();   // the tiles and w ∘ X are read by wgmma
  __syncthreads();

  // this thread's query rows s0 and s0 + 8 of the warpgroup's 64
  const int s0 = 64 * wg + 16 * warp + (lane >> 2);
  const float a2_0 = s_ad[2 * s0], a2_1 = s_ad[2 * (s0 + 8)];
  const int nk = (N + 15) / 16;    // k16 steps of the scores that hold data
  float o[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.0f;

  for (int ct = 0; ct <= wg; ++ct) {
    // S = C B^T for rows 64 wg.., columns 64 ct.., K = N in steps of 16
    wgmma_fence();
    for (int kk = 0; kk < nk; ++kk) {
      const uint32_t off = (kk >> 2) * QP * 128 + ((kk & 3) << 5);
      wgmma_ss(s, desc_b128(s_c + wg * 64 * 128 + off, 16, 1024),
               desc_b128(s_b + ct * 64 * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // S' = S ∘ L ∘ dt_r as bf16 A fragments; above the diagonal 0 (a
    // select, so the overflowing 2^(a2_s - a2_r) there never reaches y).
    // Columns r and r + 1 of a pair share one 16-byte read of (a2, dt).
    const bool diag = ct == wg;
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[8];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = 64 * ct + 16 * kk + 8 * h2 + 2 * (lane & 3);
        const float4 ad = *reinterpret_cast<const float4*>(s_ad + 2 * r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // element i = 8 kk + 4 h2 + e
          const int rr = r + (e & 1), row = s0 + (e & 2 ? 8 : 0);
          const float a2r = e & 1 ? ad.z : ad.x, dtr = e & 1 ? ad.w : ad.y;
          const float val = s[8 * kk + 4 * h2 + e] *
                            ex2((e & 2 ? a2_1 : a2_0) - a2r) * dtr;
          v[4 * h2 + e] = !diag || rr <= row ? val : 0.0f;
        }
      }
      pa[kk][0] = pack_bf16(v[0], v[1]);   // row s0, columns 0-7 of 16
      pa[kk][1] = pack_bf16(v[2], v[3]);   // row s0 + 8
      pa[kk][2] = pack_bf16(v[4], v[5]);   // row s0, columns 8-15
      pa[kk][3] = pack_bf16(v[6], v[7]);   // row s0 + 8
    }

    // y += S' X over this tile's 64 rows of X, 16 at a time
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, pa[kk],
               desc_b128(s_x + (ct * 64 + kk * 16) * 128, QP * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
  }

  bf16* yb = static_cast<bf16*>(a.y) + bb * a.ys[0] + hh * a.ys[2];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = s0 + (i & 2 ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < Q && col < P)
      *reinterpret_cast<__nv_bfloat162*>(yb + row * a.ys[1] + col) =
          __floats2bfloat162_rn(o[i], o[i + 1]);
  }

  // state [N, P] = B^T (w ∘ X), both operands MN-major, K = the Q rows in
  // steps of 16: 64-row tiles of N, owned by the first half of the
  // warpgroups, which have the fewest score tiles (warpgroup w has w + 1)
  const int nkq = (Q + 15) / 16;
  float* st = a.state + (static_cast<long long>(bb) * a.h + hh) * N * P;
  for (int mt = 0; mt < NPN; ++mt) {
    if (mt * ((NWG + 1) / 2) / NPN != wg) continue;
    wgmma_fence();
    for (int kk = 0; kk < nkq; ++kk)
      wgmma_ss_mn(o,
                  desc_b128(s_b + mt * QP * 128 + kk * 16 * 128, QP * 128,
                            1024),
                  desc_b128(s_wx + kk * 16 * 128, QP * 128, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int n = 64 * mt + 16 * warp + (lane >> 2) + (i & 2 ? 8 : 0);
      const int p = 8 * (i >> 2) + 2 * (lane & 3);
      if (n < N && p < P)
        *reinterpret_cast<float2*>(st + n * P + p) =
            make_float2(o[i], o[i + 1]);
    }
  }
}

// A [d3][d2][d1][d0] bf16 tensor (strides in elements, d0 contiguous) as a
// TMA map with boxes of 64 x rows in (d0, d2) and 1 in d1 and d3.
bool encode_map(CUtensorMap* map, const void* base, const long long (&dims)[4],
                const long long (&strides)[3], int rows) {
  const long long bytes[3] = {2 * strides[0], 2 * strides[1], 2 * strides[2]};
  const long long box[4] = {64, 1, rows, 1};
  return encode_tma_map(map, base, dims, bytes, box);
}

int launch_bf16(const SsdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  const cudaError_t err = allow_smem(ssd_chunk_wgmma_kernel, kMaxSmem, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwg = round64(a.q) / 64;
  const size_t bytes = wgmma_smem_bytes(a.q, a.n, a.p);
  if (nwg > kMaxWG || a.p > 64 || bytes > kMaxSmem || a.n % 8 || a.p % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_c, tm_b, tm_x;
  if (!encode_map(&tm_c, a.c, {a.n, 1, a.q, batch}, {a.n, a.cs[1], a.cs[0]},
                  64 * nwg) ||
      !encode_map(&tm_b, a.b, {a.n, 1, a.q, batch}, {a.n, a.bs[1], a.bs[0]},
                  64 * nwg) ||
      !encode_map(&tm_x, a.x, {a.p, a.h, a.q, batch},
                  {a.xs[2], a.xs[1], a.xs[0]}, 64 * nwg))
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_chunk_wgmma_kernel<<<dim3(a.h, batch), kWG * nwg, bytes, stream>>>(
      a, tm_c, tm_b, tm_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dims: b, q, h, n, p; strides: x (b, s, h), b (b, s), c (b, s),
// dt (b, s, h), y (b, s, h). dt and a_log are fp32; x, b, c and y share
// one storage type.
int ssd_chunk(const void* x, const void* b, const void* c, const void* dt,
              const void* a_log, void* y, void* state, void* decay,
              const long long* dims, const long long* strides, int is_bf16,
              void* stream) {
  SsdArgs a;
  a.x = x; a.b = b; a.c = c;
  a.dt = static_cast<const float*>(dt);
  a.a_log = static_cast<const float*>(a_log);
  a.y = y;
  a.state = static_cast<float*>(state);
  a.decay = static_cast<float*>(decay);
  a.q = static_cast<int>(dims[1]);
  a.h = static_cast<int>(dims[2]);
  a.n = static_cast<int>(dims[3]);
  a.p = static_cast<int>(dims[4]);
  for (int i = 0; i < 3; ++i) {
    a.xs[i] = strides[i];
    a.dts[i] = strides[7 + i];
    a.ys[i] = strides[10 + i];
  }
  a.bs[0] = strides[3]; a.bs[1] = strides[4];
  a.cs[0] = strides[5]; a.cs[1] = strides[6];
  const int batch = static_cast<int>(dims[0]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(a, batch, s) : launch<float>(a, batch, s);
}

}  // extern "C"
