// Hopper (sm_90a) kernels for the pruned-FedSGD round over the packed
// [R, 128] fp32 parameter buffer (repro_torch/core/packing.py).
//
// Each kernel replaces one Pallas TPU kernel of
// src/repro/kernels/pruning_mask.py and has a plain PyTorch version beside
// its Python wrapper (repro_torch/kernels/pruning_mask.py) that it must
// match bit for bit.
//
// All are elementwise, histogram or per-coordinate sort passes over
// a few MiB: they are bound by device-memory bytes, and at the packed sizes
// of the paper's models (R = 1024, 512 KiB a buffer) by the launch itself
// and the latency of one chain of dependent loads. The design reads every
// input once (16-byte float4 / int4 loads where a thread owns 4
// coordinates), writes every output once, and uses a grid-stride loop so
// one launch covers any R.
//
// Numerics, stated explicitly rather than left to compiler flags:
//   * every product, sum and difference is rounded on its own (__fmul_rn,
//     add.rn / sub.rn), so nvcc can never contract `acc + cw*g` or
//     `w - eta*g` into an FMA (the reference rounds each op on its own);
//   * denormals are zero where the JAX reference (XLA:CPU, TPU) flushes
//     them: the importance q = (w*v)^2 and the threshold it is compared
//     with, daz(x) = |x| < FLT_MIN ? +0 : x; and every op of the aggregate
//     tail (kernels 3, 5 and 7), which reads a subnormal input as a zero of
//     its sign and flushes a tiny result to a zero of its sign
//     (add_ftz / sub_ftz / mul_ftz; a product is tiny when its exact value
//     rounded to 24 bits with an unbounded exponent is below FLT_MIN, as
//     x86 decides it after rounding).
// The library is built without --use_fast_math and without -ftz: sums and
// differences take the .ftz form of the instruction one by one.
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs
// The histogram's cap: every block adds its bins to one accumulator, so
// fewer blocks mean fewer atomics on each bin (at R = 65,536 on the H100:
// 25.4 µs at 528 blocks, 28.7 at 2,112).
constexpr int kHistMaxBlocks = 132 * 4;
// Up to this many clients a kernel is instantiated on the count (the rank
// sort's network lives in registers, the weighted aggregate's live set in
// one ballot).
constexpr int kMaxRegisterClients = 32;

__device__ __forceinline__ float daz(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

// a + b and a - b as XLA:CPU computes them, in one instruction each: the
// .ftz form reads a subnormal input as a zero of its sign and flushes a
// subnormal result to a zero of its sign; a sum of normals below FLT_MIN is
// exact, so no rounding decides that flush.
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// XLA's flush: a subnormal becomes a zero of its sign (x + -0.0 is x for
// every x, zeros of either sign included).
__device__ __forceinline__ float flush(float x) { return add_ftz(x, -0.0f); }

// The tininess test of a product of flushed operands whose fp32 rounding
// y is +-FLT_MIN: tiny when the exact value rounded to 24 bits with an
// unbounded exponent lies below FLT_MIN (x86 decides after rounding), so a
// product within 2^-151 below FLT_MIN stays FLT_MIN. That rounding is the
// fp32 product of the operands scaled by 2^32 each (exact: a tiny product
// has no operand above 1), compared with FLT_MIN * 2^64.
__device__ __forceinline__ float edge_product(float a, float b, float y) {
  const float scaled = __fmul_rn(__fmul_rn(a, 0x1p32f), __fmul_rn(b, 0x1p32f));
  return fabsf(scaled) < 0x1p-62f ? copysignf(0.0f, y) : y;
}

// a * b as XLA:CPU computes it, on flushed operands. The fp32 product y
// (gradual underflow) decides every case but one: |y| > FLT_MIN means an
// exact product at or above FLT_MIN (not tiny), |y| < FLT_MIN one whose
// 24-bit rounding is below FLT_MIN too (tiny: flush(y)). Only |y| ==
// FLT_MIN takes the scaled test.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  const float y = __fmul_rn(a, b);
  return fabsf(y) == FLT_MIN ? edge_product(a, b, y) : flush(y);
}
__device__ __forceinline__ float xla_mul(float a, float b) {
  return mul_ftz(flush(a), flush(b));
}

__device__ __forceinline__ float4 flush4(const float4 a) {
  return make_float4(flush(a.x), flush(a.y), flush(a.z), flush(a.w));
}
__device__ __forceinline__ float4 add4_ftz(const float4 a, const float4 b) {
  return make_float4(add_ftz(a.x, b.x), add_ftz(a.y, b.y), add_ftz(a.z, b.z),
                     add_ftz(a.w, b.w));
}
__device__ __forceinline__ float4 sub4_ftz(const float4 a, const float4 b) {
  return make_float4(sub_ftz(a.x, b.x), sub_ftz(a.y, b.y), sub_ftz(a.z, b.z),
                     sub_ftz(a.w, b.w));
}

// mul_ftz of four flushed values by one flushed scalar: the scaled test is
// a branch that a lane takes only when one of its products rounds to
// +-FLT_MIN, so the common path is a product and a flush.
__device__ __forceinline__ float4 mul4_ftz(const float4 a, float s) {
  const float4 y = make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                               __fmul_rn(a.z, s), __fmul_rn(a.w, s));
  float4 r = flush4(y);
  if (fabsf(y.x) == FLT_MIN || fabsf(y.y) == FLT_MIN ||
      fabsf(y.z) == FLT_MIN || fabsf(y.w) == FLT_MIN) {
    r = make_float4(mul_ftz(a.x, s), mul_ftz(a.y, s), mul_ftz(a.z, s),
                    mul_ftz(a.w, s));
  }
  return r;
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

// Replaces pruning_mask.importance_mask_batched. One thread reads 4
// coordinates of (w, v, prunable) once, writes q once and then the
// n_clients masks; the thresholds are read from device memory (they come
// out of the on-device threshold search, never the host).
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

// g = acc * inv, step = eta * g, w' = w - step, each op rounded and flushed
// on its own (acc, inv and eta already flushed; w is flushed by the
// difference); the three results stored once, with plain stores: the next
// round reads w' and g back.
__device__ __forceinline__ void mean_update_tail(
    const float4 acc, float inv, float eta, const float4 ww,
    float4* __restrict__ w_out, float4* __restrict__ g_out,
    float4* __restrict__ step_out) {
  const float4 g = mul4_ftz(acc, inv);
  const float4 st = mul4_ftz(g, eta);
  *g_out = g;
  *step_out = st;
  *w_out = sub4_ftz(ww, st);
}

// cw * g for a flushed weight: a unit weight's product is exact, so it is
// the flushed gradient (the branch is uniform: one weight a client).
__device__ __forceinline__ float4 weighted(float cw, const float4 g) {
  return cw == 1.0f ? flush4(g) : mul4_ftz(flush4(g), cw);
}

// Clients in flight a thread: the loads of a batch are all issued before
// its first add, which bounds the registers at C = 32.
constexpr int kBatch = 8;

// Vectors [i, n4) of the weighted aggregate for a known client count C <= 32
// whose live weights (bit c of `live`) are all 1: a term is the gradient
// itself (add_ftz flushes it). Every live client's float4 of a batch is
// loaded (predicated on the live set, not behind a read of cw) before the
// batch's first add; the sum then runs in stack order from client 0's term.
template <int C>
__device__ __forceinline__ void unit_weight_rows(
    const float4* __restrict__ w, const float4* __restrict__ grads,
    unsigned live, float inv, float eta, long long n4,
    float4* __restrict__ w_out, float4* __restrict__ g_out,
    float4* __restrict__ step_out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 ww = __ldg(w + i);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += kBatch) {
      float4 t[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + j;
        t[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (c < C && (live >> c & 1u)) t[j] = __ldg(grads + c * n4 + i);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + j;
        if (c < C && (live >> c & 1u)) {
          acc = c == 0 ? flush4(t[j]) : add4_ftz(acc, t[j]);
        }
      }
    }
    mean_update_tail(acc, inv, eta, ww, w_out + i, g_out + i, step_out + i);
  }
}

// Replaces pruning_mask.fedsgd_aggregate_weighted. A client whose weight is
// not > 0 is skipped without reading its gradient, so a NaN on a padding or
// quarantined client never reaches the sum and its bytes are never read;
// the weight is flushed first, as XLA compares it (a subnormal one is 0).
// The sum runs in client-stack order and starts from client 0's term (XLA
// folds the mirror's +0.0 start away, so a -0.0 keeps its sign); a dead
// client 0 leaves it at +0.0, as the mirror's `where` does. inv and eta are
// device scalars (inv comes out of the on-device quarantine: no host sync
// per round).
//
// Bound by bytes (w, the live gradients, three outputs), at R = 1024 by the
// latency of one chain of loads. The round's weights are 0 and 1, and for
// them C = 1..32 are instantiations: lane c of each warp reads cw[c] once,
// a ballot gives the live set and a vote that every live weight is 1, and
// then every live client's load of a batch of 8 is in flight at once
// (unit_weight_rows), instead of one dependent read of cw and of the
// gradient a client. Other weights, and C = 0 (any count), take the client
// loop: it reads cw[c] and the gradient behind it, one client at a time.
template <int C>
__global__ void __launch_bounds__(kThreads) fedsgd_aggregate_weighted_kernel(
    const float4* __restrict__ w, const float4* __restrict__ grads,
    const float* __restrict__ cw, int n_clients,
    const float* __restrict__ inv_ptr, const float* __restrict__ eta_ptr,
    long long n4, float4* __restrict__ w_out, float4* __restrict__ g_out,
    float4* __restrict__ step_out) {
  static_assert(C >= 0 && C <= kMaxRegisterClients && kMaxRegisterClients <= 32,
                "a live set in one 32-bit ballot");
  const float inv = flush(__ldg(inv_ptr));
  const float eta = flush(__ldg(eta_ptr));
  if constexpr (C > 0) {
    // every lane reaches this point: the ballot and vote see a whole warp
    const int lane = threadIdx.x & 31;
    const float x = lane < C ? flush(__ldg(cw + lane)) : 0.0f;
    const unsigned live = __ballot_sync(0xffffffffu, x > 0.0f);
    if (__all_sync(0xffffffffu, !(x > 0.0f) || x == 1.0f)) {
      unit_weight_rows<C>(w, grads, live, inv, eta, n4, w_out, g_out,
                          step_out);
      return;
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < n_clients; ++c) {
      const float wc = flush(__ldg(cw + c));
      if (wc > 0.0f) {
        const float4 t = weighted(wc, __ldg(grads + c * n4 + i));
        acc = c == 0 ? t : add4_ftz(acc, t);
      }
    }
    mean_update_tail(acc, inv, eta, __ldg(w + i), w_out + i, g_out + i,
                     step_out + i);
  }
}

// Adds the exponent byte of each lane's coordinate to the block's bins. A
// lane whose coordinate is not prunable, or whose byte is negative (a set
// sign bit), adds nothing. Where every counting lane of the warp holds the
// same byte (round 0's all-zero q puts every coordinate in bin 0) the
// lowest of them adds the warp's count in one shared atomic, not 32 on one
// address; otherwise each lane adds its own. Every lane of the warp must
// call it.
__device__ __forceinline__ void count_byte(int* bins, int bits, float p) {
  const int b = bits >> 23;                   // arithmetic: < 0 if signed
  const bool ok = p > 0.0f && b >= 0;
  const unsigned valid = __ballot_sync(0xffffffffu, ok);
  if (!valid) return;
  const int lead = __ffs(valid) - 1;
  const int b0 = __shfl_sync(0xffffffffu, b, lead);
  if (__ballot_sync(0xffffffffu, ok && b == b0) == valid) {
    if ((threadIdx.x & 31) == lead) atomicAdd(&bins[b0], __popc(valid));
  } else if (ok) {
    atomicAdd(&bins[b], 1);
  }
}

// An acquire-release atomic add on a device-scope counter: it publishes
// the writes that reach it (this block's, ordered before it by a barrier)
// and, in the block that reads the last ticket, sees every earlier block's.
__device__ __forceinline__ int take_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// Replaces pruning_mask.exponent_histogram, in one launch that writes the
// [256] output once. Blocks run in no order on the card, so instead of the
// TPU's running total over sequential grid steps each block counts its
// share into 256 shared-memory bins (`count_byte`), adds each non-zero bin
// to a per-stream [256] accumulator (fire-and-forget atomics, no fill: the
// accumulator is 0 between calls), and takes a ticket from a per-stream
// counter; the block that takes the last ticket swaps the accumulator's
// bins for 0 as it reads them, writes the histogram, and resets the counter
// (the wrapper keeps one accumulator and counter for each stream). Integer
// counts are exact in any order. One int4 and one float4 a thread and
// iteration: 2 or 4 a thread, all loaded before counting, read slower at
// R = 1024 and no faster at 65,536 on the H100. Bytes outside [0, 255] (a
// set sign bit) are dropped, as the Pallas compare-reduce drops them.
// Bound by bytes: 2 reads of one buffer.
__global__ void __launch_bounds__(kThreads) exponent_histogram_ticket_kernel(
    const int4* __restrict__ qbits, const float4* __restrict__ prunable,
    long long n4, int* __restrict__ acc, int* __restrict__ ticket,
    int* __restrict__ hist) {
  __shared__ int bins[256];
  __shared__ int s_ticket;
  static_assert(kThreads == 256, "one bin a thread");
  const int t = threadIdx.x;
  bins[t] = 0;
  __syncthreads();
  // n4 is a multiple of 32 (rows of 128 lanes) and a warp's 32 vectors
  // start at a multiple of 32, so the loop bound is uniform across a warp
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
       i < n4; i += stride) {
    const int4 qb = __ldg(qbits + i);
    const float4 p = __ldg(prunable + i);
    count_byte(bins, qb.x, p.x);
    count_byte(bins, qb.y, p.y);
    count_byte(bins, qb.z, p.z);
    count_byte(bins, qb.w, p.w);
  }
  __syncthreads();
  if (bins[t]) atomicAdd(acc + t, bins[t]);
  __syncthreads();
  if (t == 0) s_ticket = take_ticket(ticket);
  __syncthreads();
  if (s_ticket != static_cast<int>(gridDim.x) - 1) return;
  hist[t] = atomicExch(acc + t, 0);
  if (t == 0) *ticket = 0;
}

// Replaces pruning_mask.importance_mask_2d together with
// ops.packed_importance_mask's prunable override, for one threshold shared
// by every client: q = daz((w*v)^2) and mask = prunable > 0 ? q >= thr : 1.
// The threshold is read once and flushed into a register; a thread takes
// one float4 of w, v and prunable an iteration (2 or 4, all loaded before
// the first store, read slower at R = 1024 and no faster at 65,536 on the
// H100) and streams q and the mask out (st.global.cs: neither is read
// again by this kernel). Bound by bytes: 3 reads and 2 writes of one
// buffer.
__global__ void __launch_bounds__(kThreads) importance_mask_2d_kernel(
    const float4* __restrict__ w, const float4* __restrict__ v,
    const float4* __restrict__ prunable, const float* __restrict__ thr_ptr,
    long long n4, float4* __restrict__ q, float4* __restrict__ mask) {
  const float thr = daz(__ldg(thr_ptr));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 a = __ldg(w + i);
    const float4 b = __ldg(v + i);
    const float4 p = __ldg(prunable + i);
    float4 qq, m;
    qq.x = importance(a.x, b.x);
    qq.y = importance(a.y, b.y);
    qq.z = importance(a.z, b.z);
    qq.w = importance(a.w, b.w);
    m.x = keep(p.x, qq.x, thr);
    m.y = keep(p.y, qq.y, thr);
    m.z = keep(p.z, qq.z, thr);
    m.w = keep(p.w, qq.w, thr);
    __stcs(q + i, qq);
    __stcs(mask + i, m);
  }
}

// Replaces pruning_mask.fedsgd_aggregate: the unweighted eqs. (6)-(7),
// reached through ops.packed_fedsgd_update. The sum runs in client-stack
// order from the first client's gradient (acc = g[0]; acc = acc + g[c]),
// then g = acc * inv with inv = float32(1/C) from the host, step = eta*g
// and w' = w - step, each op rounded and flushed on its own: the sequence
// the xla mirror writes and the weighted kernel computes. (XLA:CPU
// reassociates the mirror's step into (eta * inv) * acc, the same bits only
// when 1/C is a power of two, and at C = 1 drops its * 1.0, so a subnormal
// g[0] leaves its g unflushed; the port keeps the written order and the
// flush.) Bound by bytes: reads w and C gradients, writes 3 buffers.
__global__ void fedsgd_aggregate_kernel(
    const float4* __restrict__ w, const float4* __restrict__ grads,
    int n_clients, float inv, float eta, long long n4,
    float4* __restrict__ w_out, float4* __restrict__ g_out,
    float4* __restrict__ step_out) {
  inv = flush(inv);
  eta = flush(eta);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    // every use of acc flushes it, so g[0] may be flushed up front; add_ftz
    // flushes each later gradient as it reads it
    float4 acc = flush4(grads[i]);
    for (int c = 1; c < n_clients; ++c) {
      acc = add4_ftz(acc, grads[static_cast<long long>(c) * n4 + i]);
    }
    mean_update_tail(acc, inv, eta, w[i], w_out + i, g_out + i, step_out + i);
  }
}

// Replaces pruning_mask.masked_update_2d: (w - eta*g) * mask, each op
// rounded and flushed on its own, as the eager ref.masked_update_ref
// computes it. Bound by bytes: 3 reads, 1 write. One float4 of each input a
// thread an iteration (__ldg), the output streamed (st.global.cs: nothing
// here reads it again). A warp-wide path for 0/1 masks that skips the last
// product's flush read no faster on the H100, at R = 1024 or 65,536, so
// every mask takes xla_mul.
__global__ void __launch_bounds__(kThreads) masked_update_kernel(
    const float4* __restrict__ w, const float4* __restrict__ g,
    const float4* __restrict__ m, float eta, long long n4,
    float4* __restrict__ out) {
  eta = flush(eta);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 step = mul4_ftz(flush4(__ldg(g + i)), eta);
    const float4 x = sub4_ftz(__ldg(w + i), step);
    const float4 k = __ldg(m + i);
    __stcs(out + i, make_float4(xla_mul(x.x, k.x), xla_mul(x.y, k.y),
                                xla_mul(x.z, k.z), xla_mul(x.w, k.w)));
  }
}

// Monotone int32 total-order key of an fp32 bit pattern: b ^ ((b >> 31) &
// 0x7fffffff) compares like the float values, -0.0 strictly below +0.0.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Replaces pruning_mask.client_rank_sort, the first stage of the
// coordinate-wise median and the trimmed mean. One thread owns one
// coordinate of the [C, n] stack: it reads the coordinate's C values (row
// c of neighbouring threads is one contiguous segment, so every read is
// coalesced), keys them (zero-weight clients get the INT_MAX sentinel and
// sort last; the weight is flushed first, as XLA compares it), runs the odd-even transposition network of the TPU kernel
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
      key[c] = flush(__ldg(&cw[c])) > 0.0f ? order_key(v) : INT_MAX;
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
      keys[at] = flush(cw[c]) > 0.0f ? order_key(v) : INT_MAX;
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

// f(std::integral_constant<int, C>{}) with C = n_clients for 1 <= C <=
// kMaxRegisterClients, and with C = 0 for any other count: picks a kernel
// instantiated on C.
template <int C = 1, class F>
int with_client_count(int n_clients, F&& f) {
  if (n_clients == C) return f(std::integral_constant<int, C>{});
  if constexpr (C < kMaxRegisterClients) {
    return with_client_count<C + 1>(n_clients, f);
  } else {
    return f(std::integral_constant<int, 0>{});
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
  return with_client_count(n_clients, [&](auto c) {
    fedsgd_aggregate_weighted_kernel<decltype(c)::value>
        <<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(w), static_cast<const float4*>(grads),
            static_cast<const float*>(cw), n_clients,
            static_cast<const float*>(inv), static_cast<const float*>(eta),
            n4, static_cast<float4*>(w_out), static_cast<float4*>(g_out),
            static_cast<float4*>(step_out));
    return static_cast<int>(cudaGetLastError());
  });
}

// state: int32 [257], the accumulator's 256 bins and the ticket, 0
// between calls (the kernel leaves them so), one per stream.
int exponent_histogram(const void* q, const void* prunable, long long n,
                       void* state, void* hist, void* stream) {
  const int blocks = std::min(grid_for(n / 4), kHistMaxBlocks);
  int* acc = static_cast<int*>(state);
  exponent_histogram_ticket_kernel<<<blocks, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(q), static_cast<const float4*>(prunable),
      n / 4, acc, acc + 256, static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

int importance_mask_2d(const void* w, const void* v, const void* prunable,
                       const void* thr, long long n, void* q, void* mask,
                       void* stream) {
  importance_mask_2d_kernel<<<grid_for(n / 4), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<const float4*>(v),
      static_cast<const float4*>(prunable), static_cast<const float*>(thr),
      n / 4, static_cast<float4*>(q), static_cast<float4*>(mask));
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
  const auto* g = static_cast<const float*>(grads);
  const auto* w = static_cast<const float*>(cw);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_client_count(n_clients, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if constexpr (C > 0) {
      client_rank_sort_kernel<C><<<grid_for(n), kThreads, 0, st>>>(g, w, n,
                                                                   o);
    } else {
      client_rank_sort_generic_kernel<<<grid_for(n), kThreads, 0, st>>>(
          g, w, n_clients, n, o, static_cast<int*>(keys));
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
