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
// card's ridge, so the design is about keeping enough bytes in flight.
//
// Split-KV: the grid is (Hkv, B, NS). Block (hk, b, s) takes keys
// [s * chunk, (s + 1) * chunk) of row b, clipped at pos[b]; the host picks
// the chunk from Skv and B * Hkv alone (never from pos, which stays on the
// device), for at least two waves on 132 SMs: 256-key chunks give NS = 8
// and 512 blocks on the served caches [8, 2048, 8, 64]. A block computes
// all G = Hq / Hkv query heads of its kv head, so each cache row is read
// once, not G times. Its chunk streams through shared memory in tiles of
// 8 KB of K and 8 KB of V, by cp.async (16 bytes a thread, zero-filled
// past the chunk) into a two-stage ring: the next tile's load is in
// flight while this tile is read. A key row is split over D / 8 lanes,
// each reading 8 contiguous elements, so a warp reads 32 / (D / 8) whole
// rows per instruction; each such lane group is an online-softmax worker,
// and the workers' (m, l, acc) are merged through shared memory at the
// end, then written as the block's fp32 partial. Blocks whose chunk
// starts at or past pos[b] read and write nothing.
//
// One launch: every block then takes a ticket from an int32 counter of
// its (b, kv head) (after a __threadfence, so its partial is visible
// first); the last of the NS merges the live partials (those below
// pos[b]) with the same max-rescaled sum, writes the output and resets
// the counter to 0 for the next call. The wrapper keeps the counters per
// device and zeroes them once; calls on one device must not run
// concurrently on two streams. The merge reads the partials in split
// order, so the result does not depend on which block finished last.

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;
constexpr int kStageBytes = 8192;          // K (and V) bytes of one tile

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;    // [B] valid cache lengths
  void* o;
  float* part_m;     // [B * Hkv * NS, G] partials: running max,
  float* part_l;     //   sum of p,
  float* part_acc;   //   [B * Hkv * NS, G, D] sum of p v
  int* tickets;      // [B * Hkv], 0 between calls
  int skv, chunk, nsplit;
  long long qs[2];   // q strides of (b, h)
  long long ks[3];   // cache strides of (b, s, h)
  long long vs[3];
  long long os[2];   // out strides of (b, h)
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const DecodeArgs a) {
  constexpr int LPK = D / 8;              // lanes per key row
  constexpr int NG = 32 / LPK;            // key workers per warp
  constexpr int NW = (kThreads / 32) * NG;
  constexpr int TK = kStageBytes / (D * static_cast<int>(sizeof(T)));
  constexpr int KPW = TK / NW;            // keys per worker and tile
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = D / VEC;            // 16-byte chunks per row
  static_assert(KPW >= 1 && TK % NW == 0, "tile must split over workers");
  static_assert(NW * G * D * 4 <= 4 * kStageBytes, "merge must fit");
  // two stages of (K, V) tiles; after the loop, the workers' accumulators
  __shared__ __align__(16) unsigned char s_buf[4 * kStageBytes];
  __shared__ float s_m[NW][G], s_l[NW][G];
  __shared__ int s_ticket;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int row = b * gridDim.x + hk;     // (batch row, kv head)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, grp = lane / LPK, worker = warp * NG + grp;
  const int d0 = sub * 8;
  const int n = min(max(a.pos[b], 0), a.skv);
  const int c0 = split * a.chunk, c1 = min(c0 + a.chunk, n);
  const long long slot = static_cast<long long>(row) * a.nsplit + split;

  if (c0 < n) {
    const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
    const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
    T* s_k = reinterpret_cast<T*>(s_buf);     // [2][TK][D], then V
    T* s_v = s_k + 2 * TK * D;
    auto issue = [&](int t) {
      const int st = t & 1;
      for (int i = threadIdx.x; i < TK * CPR; i += kThreads) {
        const int r = i / CPR, c = i - r * CPR, key = c0 + t * TK + r;
        const bool ok = key < c1;
        const long long kr = ok ? key : c0;
        cp_async16(s_k + (st * TK + r) * D + c * VEC,
                   kb + kr * a.ks[1] + c * VEC, ok);
        cp_async16(s_v + (st * TK + r) * D + c * VEC,
                   vb + kr * a.vs[1] + c * VEC, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    const int n_tiles = (c1 - c0 + TK - 1) / TK;
    issue(0);

    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0];
    float qr[G][8], m[G], l[G], acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load8(qb + (hk * G + g) * a.qs[1] + d0, qr[g]);
      m[g] = kNegInf;
      l[g] = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
    }

    for (int t = 0; t < n_tiles; ++t) {
      // tile t has landed, and every thread is done with tile t - 1,
      // whose stage the next load overwrites
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (t + 1 < n_tiles) issue(t + 1);
      const T* tk = s_k + (t & 1) * TK * D;
      const T* tv = s_v + (t & 1) * TK * D;
      // every lane runs every key slot (the shuffles' mask is the warp);
      // the update is per key
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        const int r = u * NW + worker, key = c0 + t * TK + r;
        float kk[8], vv[8], s[G];
        load8(tk + r * D + d0, kk);
        load8(tv + r * D + d0, vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float x = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) x = fmaf(qr[g][e], kk[e], x);
          s[g] = x;
        }
#pragma unroll
        for (int off = LPK / 2; off; off >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] += __shfl_xor_sync(kFullMask, s[g], off);
        if (key < c1) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float x = s[g] * a.scale;
            const float m_new = fmaxf(m[g], x);
            const float corr = expf(m[g] - m_new), p = expf(x - m_new);
            l[g] = l[g] * corr + p;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[g][e] = fmaf(p, vv[e], acc[g][e] * corr);
            m[g] = m_new;
          }
        }
      }
    }
    __syncthreads();               // the tiles' memory becomes s_acc

    // the workers' partials -> the block's, max-rescaled
    float* s_acc = reinterpret_cast<float*>(s_buf);   // [NW][G][D]
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s_acc[(worker * G + g) * D + d0 + e] = acc[g][e];
      if (sub == 0) {
        s_m[worker][g] = m[g];
        s_l[worker][g] = l[g];
      }
    }
    __syncthreads();
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
        osum += s_acc[(w * G + g) * D + d] * f;
      }
      a.part_acc[slot * G * D + i] = osum;
      if (d == 0) {
        a.part_m[slot * G + g] = mx;
        a.part_l[slot * G + g] = lsum;
      }
    }
    __threadfence();               // the partial before the ticket
  }

  __syncthreads();
  if (threadIdx.x == 0) s_ticket = atomicAdd(a.tickets + row, 1);
  __syncthreads();
  if (s_ticket != a.nsplit - 1) return;

  // the last block of (b, hk): merge the live partials in split order
  __threadfence();
  const int live = (n + a.chunk - 1) / a.chunk;
  const long long first = static_cast<long long>(row) * a.nsplit;
  T* ob = static_cast<T*>(a.o) + b * a.os[0];
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
    for (int s = 0; s < live; ++s)
      mx = fmaxf(mx, __ldcg(a.part_m + (first + s) * G + g));
    float lsum = 0.0f, osum = 0.0f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(__ldcg(a.part_m + (first + s) * G + g) - mx);
      lsum += __ldcg(a.part_l + (first + s) * G + g) * f;
      osum += __ldcg(a.part_acc + (first + s) * G * D + i) * f;
    }
    ob[(hk * G + g) * a.os[1] + d] = from_f<T>(osum / fmaxf(lsum, 1e-20f));
  }
  if (threadIdx.x == 0) a.tickets[row] = 0;
}

template <typename T, int D, int G>
int launch(const DecodeArgs& a, int batch, int hkv, cudaStream_t stream) {
  decode_attention_kernel<T, D, G>
      <<<dim3(hkv, batch, a.nsplit), kThreads, 0, stream>>>(a);
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

// dims: b, hq, hkv, skv, d, chunk; strides: q (b, h), k (b, s, h),
// v (b, s, h), o (b, h); pos: device int32 [b]; part: fp32 scratch of
// b * hkv * ceil(skv / chunk) * (hq / hkv) * (d + 2) floats; tickets:
// device int32 [b * hkv], zero.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* pos, void* o, void* part, void* tickets,
                     const long long* dims, const long long* strides,
                     int is_bf16, float scale, void* stream) {
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.pos = static_cast<const int*>(pos);
  const int batch = static_cast<int>(dims[0]), hkv = static_cast<int>(dims[2]);
  const int g = static_cast<int>(dims[1] / dims[2]), d = static_cast<int>(dims[4]);
  a.skv = static_cast<int>(dims[3]);
  a.chunk = static_cast<int>(dims[5]);
  a.nsplit = (a.skv + a.chunk - 1) / a.chunk;
  const long long slots = static_cast<long long>(batch) * hkv * a.nsplit;
  a.part_m = static_cast<float*>(part);
  a.part_l = a.part_m + slots * g;
  a.part_acc = a.part_l + slots * g;
  a.tickets = static_cast<int*>(tickets);
  a.qs[0] = strides[0]; a.qs[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    a.ks[i] = strides[2 + i];
    a.vs[i] = strides[5 + i];
  }
  a.os[0] = strides[8]; a.os[1] = strides[9];
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(a, batch, hkv, g, d, s)
                 : launch_d<float>(a, batch, hkv, g, d, s);
}

}  // extern "C"
