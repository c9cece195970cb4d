// Forward flash attention for Hopper (sm_90a): GQA, causal mask, sliding
// window (kpos > qpos - window), softcap cap * tanh(s / cap), fp32 online
// softmax with NEG_INF = -2^30, fp32 accumulation, fp32 or bf16 storage.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, pallas_call at :103). The TPU kernel walks a
// sequential kv grid axis and carries m, l and the accumulator in VMEM
// scratch; here one block owns BQ query rows of one (batch, head) and
// loops over the kv tiles itself, so nothing is carried between blocks.
// Grid: (ceil(Sq / BQ), Hq, B); query head h reads kv head h / (Hq / Hkv).
// The tiles that lie wholly outside the causal / window band of the
// block's rows are never loaded: the loop runs from the first tile with
// k_end > q_start - window to the last with k_start <= q_end, the TPU
// kernel's skip.
//
// Bound: the live FLOPs (4 * D per unmasked (q, k) pair and head) at the
// tensor cores' rate against the bytes (q, k, v, o once each); for
// granite's heads (32/8, D 64) the bytes bound below ~740 tokens and the
// operations above. This first version runs on CUDA cores (fp32 FMAs from
// shared memory), a simple, exact design, far from either bound:
// tiles are staged in shared memory as fp32, a K row padded by one
// word so that lanes reading different keys hit different banks; each of
// the 4 warps owns BQ / 4 query rows, a lane owns 2 keys of a 64-key tile
// for the scores and D / 32 output dims for P V. wgmma / TMA are later
// work.
//
// Inputs are addressed by strides (elements; the last dim contiguous), so
// the model layout [B, S, H, D] and the kernel layout [B, H, S, D] are
// both read without a copy.

#include "common.cuh"

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

}  // namespace

extern "C" {

// dims: b, hq, hkv, sq, skv, d; strides: q, k, v, o as (b, h, s) each.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* dims, const long long* strides,
                    int is_bf16, int causal, int window, float cap,
                    float scale, void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
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
  return is_bf16 ? launch_d<__nv_bfloat16>(a, batch, d, s)
                 : launch_d<float>(a, batch, d, s);
}

}  // extern "C"
