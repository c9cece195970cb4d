// The Mamba2 SSD step inside one chunk for Hopper (sm_90a), per (batch,
// head): with a = cumsum(dt * A) over the chunk (A = -exp(a_log)),
//   L[s, r] = exp(a_s - a_r) for r <= s, 0 above the diagonal (masked
//             BEFORE the exp, NEG = -1e30, as the TPU kernel);
//   y       = (C B^T ∘ L) (dt ∘ X)                      [Q, P], x's type
//   state   = ((exp(a_Q - a_r) ∘ B)^T (dt ∘ X))          [N, P], fp32
//   decay   = exp(a_Q)                                          fp32
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py
// (`ssd_chunk`, pallas_call at :57), grid (B, H) as there. The TPU holds
// the whole chunk in VMEM; a Hopper block has at most 227 KB of shared
// memory, and fp32 B and C tiles of [128, 128] (64 KB each) with the
// [Q, Q] scores (64 KB) and X (32 KB) would not leave room. So only the
// scores [Q][Q+1] and dt ∘ X [Q][P] stay resident in fp32 (dynamic shared
// memory, 130.5 KB at Q = 128, P = 64), and B and C pass through in
// 32-column slices, accumulated into the scores, then B again, scaled by
// its decay, for the state. The cumulative sum is taken sequentially, in
// the reference's order.
//
// Bound: bytes at the served sizes (mamba2's chunk: 1.65 MB in and out
// against 78 MFLOP at the tensor cores' rate). The live work is
// Q(Q+1)/2 * N MACs for the scores per batch row, and per head
// Q(Q+1)/2 * P for y and Q * N * P for the state. This first version runs
// on CUDA cores, far from the bound; the scores C B^T are the same for
// every head of a batch row and are recomputed per head (later work: one
// pass per batch row, tensor cores).

#include "common.cuh"

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
  return is_bf16 ? launch<__nv_bfloat16>(a, batch, s) : launch<float>(a, batch, s);
}

}  // extern "C"
