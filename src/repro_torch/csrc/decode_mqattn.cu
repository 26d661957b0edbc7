// Decode attention for Hopper (sm_90a) over a mixed or an all-int8
// cache.  Mixed: one new token per row attends a cache whose positions
// live either in the bf16 window or in int8 quant-resident segments
// (per-(token, kv-head) fp32 scales), selected per position by
// quant_mask.  All-int8 (template ALL_QUANT): every position is int8
// codes and scales, with no bf16 cache and no mask.  Either optionally
// also emits the Eq.-1 per-key attention mass that feeds the Eq.-3 bit
// plan.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/decode_qattn.py  decode_mqattn (_mixed_kernel)
//   src/repro/kernels/decode_qattn.py  decode_qattn  (_kernel)
// and adds what the reference computes beside them on its jnp paths
// (src/repro/models/common.py mixed_decode_attention and
// decode_attention with scales): the per-key mass and the bf16-rounded
// p of the plain select path.  The plain PyTorch versions are
// src/repro_torch/kernels/ref.py decode_mqattn_plain and
// decode_qattn_plain.  Both C entry points below share one kernel
// template.
//
// The function.  q (B,H,hd) bf16; k, v (B,S,KV,hd) bf16; kq, vq int8 of
// the same shape; ks, vs (B,S,KV) fp32; qmask (B,S) bool; n_valid (B,)
// int32.  Key j of row b is valid when j < n_valid[b] and, with a
// window, j >= n_valid[b] - window or j < n_sinks.  At a quant position
// of the mixed cache the key/value is bf16(code * scale) (the value a
// full dequantization materializes), elsewhere the bf16 cache value.
// In the all-int8 cache it is code * scale in fp32 in the fused form
// (the Pallas decode_qattn) and bf16(code * scale) in the select form
// (decode_attention with scales).  Scores are fp32 times
// 1/sqrt(hd); invalid keys take the finite NEG_INF = -0.7 FLT_MAX.  Query
// head h reads kv-head h / G, G = H / KV.  Two forms (template SELECT):
//   fused  — out = bf16(sum_j exp(s_j - m) v_j / max(l, 1e-30)), PV fp32;
//   select — p = exp(s - m) / l rounded to bf16, PV accumulated in fp32,
//            out = bf16(sum).
// mass (B,S) = sum over heads of exp(s - m) / max(l, 1e-30), over H.
//
// Design.  One block of 8 warps per (b, kv-head), holding all G query
// heads of the group.  A warp takes 4 consecutive keys at a time (groups
// strided over the warps), issuing the 4 row loads before using any;
// lane t owns head-dim elements [t*PER, t*PER + PER), so the warp reads
// each K/V row in one contiguous sweep.  Three passes:
//   1. scores of the valid keys (warp dot product, butterfly reduce) to
//      a (B,H,S) fp32 scratch in device memory, and the running max;
//   2. l = sum exp(s - m), thread-strided over the scratch;
//   3. p (and, with MASS, p / l back into the scratch), PV into per-lane
//      fp32 accumulators, then a fixed-order sum over the warps in
//      shared memory.
// A second launch sums the scratch over heads into the mass.  Every
// reduction runs in a fixed order and no atomics are used, so reruns are
// bit-identical.
//
// Bound.  Memory: the valid keys' bytes, n_valid * KV * (2 hd * 2) at
// bf16 positions and n_valid * KV * (2 hd + 8) at quant positions (all
// of them in the all-int8 cache), per layer.  This first version reads only the valid rows, but it runs one
// block per (b, kv-head) — 32 blocks for llama2-7b at batch 1 on 132 SMs
// — with only 4 rows in flight per warp, so it is latency-bound well
// above that bound; splitting S across blocks (flash-decoding) and
// reading K/V through the page tables are later work.
//
// Numerics: expf (accurate, no --use_fast_math), IEEE division
// (-prec-div=true), __float2bfloat16_rn for every bf16 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys a warp has in flight at once
constexpr int kMaxHd = 128;
constexpr int kMaxGroup = 8;
// the port's NEG_INF: -0.7 * float32 max computed in double, then cast
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  const uint8_t* qmask;
  const int* n_valid;
  __nv_bfloat16* out;
  float* scratch;
  int S, H, KV, hd, window, n_sinks;
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool key_valid(int j, int nv, int window,
                                          int n_sinks) {
  return j < nv && (window <= 0 || j >= nv - window || j < n_sinks);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // identical on every lane: each butterfly step commutes
}

// This lane's PER elements of one attended (b, j, kv-head) row; a
// dequantized value is rounded to bf16 when ROUND.
template <int PER, bool ROUND>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ x,
                                         const int8_t* __restrict__ xq,
                                         const float* __restrict__ xs,
                                         size_t row, int hd, bool quant,
                                         int lane, float (&r)[PER]) {
  const int d0 = lane * PER;
  if (quant) {
    const float sc = xs[row];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = d0 + i;
      const float y = d < hd ? (float)xq[row * hd + d] * sc : 0.0f;
      r[i] = ROUND ? bf16_round(y) : y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = d0 + i;
      r[i] = d < hd ? __bfloat162float(x[row * hd + d]) : 0.0f;
    }
  }
}

template <int PER, int GMAX, bool SELECT, bool MASS, bool ALL_QUANT>
__global__ void __launch_bounds__(kThreads)
    mqattn_kernel(const Args a) {
  // the mixed cache attends bf16(code * scale); the all-int8 cache
  // rounds only in the select form
  constexpr bool kRound = !ALL_QUANT || SELECT;
  // shared: [kWarps][G*hd] PV partials, then [kWarps][GMAX] max / sum
  extern __shared__ float smem[];
  const int S = a.S, H = a.H, KV = a.KV, hd = a.hd;
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, h0 = kvh * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = min(a.n_valid[b], S);
  const int GH = G * hd;
  float* red = smem;
  float* wstat = smem + kWarps * GH;
  float* srow = a.scratch + ((size_t)b * H + h0) * S;  // + g * S + j
  const uint8_t* qm = ALL_QUANT ? nullptr : a.qmask + (size_t)b * S;

  float qr[GMAX][PER];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane * PER + i;
      qr[g][i] = (g < G && d < hd)
                     ? __bfloat162float(a.q[((size_t)b * H + h0 + g) * hd + d])
                     : 0.0f;
    }

  // ---- pass 1: scores of the valid keys, running max --------------- //
  float mloc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) mloc[g] = kNegInf;
  for (int j0 = warp * kUnroll; j0 < nv; j0 += kWarps * kUnroll) {
    float kr[kUnroll][PER];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // all rows' loads in flight
      const int j = j0 + u;
      ok[u] = key_valid(j, nv, a.window, a.n_sinks);
      if (ok[u])
        load_row<PER, kRound>(a.k, a.kq, a.ks,
                              ((size_t)b * S + j) * KV + kvh, hd,
                              ALL_QUANT || qm[j] != 0, lane, kr[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < PER; ++i) part += qr[g][i] * kr[u][i];
        const float s = warp_sum(part) * a.scale;
        if (lane == 0) srow[(size_t)g * S + j0 + u] = s;
        mloc[g] = fmaxf(mloc[g], s);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) wstat[warp * GMAX + g] = mloc[g];
  }
  __syncthreads();
  float m[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float x = kNegInf;
    if (g < G)
      for (int w = 0; w < kWarps; ++w) x = fmaxf(x, wstat[w * GMAX + g]);
    m[g] = x;
  }

  // ---- pass 2: l = sum exp(s - m) ----------------------------------- //
  float lloc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) lloc[g] = 0.0f;
  for (int j = threadIdx.x; j < nv; j += kThreads) {
    if (!key_valid(j, nv, a.window, a.n_sinks)) continue;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) lloc[g] += expf(srow[(size_t)g * S + j] - m[g]);
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) lloc[g] = warp_sum(lloc[g]);
  __syncthreads();  // every thread has read the maxima
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) wstat[warp * GMAX + g] = lloc[g];
  }
  __syncthreads();
  float linv[GMAX];  // max(l, 1e-30), the divisor of both forms
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float x = 0.0f;
    if (g < G)
      for (int w = 0; w < kWarps; ++w) x += wstat[w * GMAX + g];
    linv[g] = fmaxf(x, 1e-30f);
  }

  // ---- pass 3: p, mass, PV ------------------------------------------ //
  float acc[GMAX][PER];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[g][i] = 0.0f;
  const int jend = MASS ? S : nv;
  for (int j0 = warp * kUnroll; j0 < jend; j0 += kWarps * kUnroll) {
    float vr[kUnroll][PER];
    float sv[kUnroll][GMAX];  // lane 0's scores, read before any write
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      ok[u] = key_valid(j, nv, a.window, a.n_sinks);
      if (ok[u])
        load_row<PER, kRound>(a.v, a.vq, a.vs,
                              ((size_t)b * S + j) * KV + kvh, hd,
                              ALL_QUANT || qm[j] != 0, lane, vr[u]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        sv[u][g] = (ok[u] && g < G && lane == 0) ? srow[(size_t)g * S + j]
                                                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      if (!ok[u]) {
        if (MASS && lane == 0 && j < S)
          for (int g = 0; g < G; ++g) srow[(size_t)g * S + j] = 0.0f;
        continue;
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float p = expf(__shfl_sync(0xffffffffu, sv[u][g], 0) - m[g]);
        const float pn = p / linv[g];
        if (MASS && lane == 0) srow[(size_t)g * S + j] = pn;
        const float pw = SELECT ? bf16_round(pn) : p;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[g][i] += pw * vr[u][i];
      }
    }
  }

  // ---- fixed-order sum over the warps, normalise, store ------------- //
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane * PER + i;
      if (d < hd) red[warp * GH + g * hd + d] = acc[g][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GH; e += kThreads) {
    float x = 0.0f;
    for (int w = 0; w < kWarps; ++w) x += red[w * GH + e];
    const int g = e / hd, d = e % hd;
    if (!SELECT) {
      float l = 0.0f;  // the same fixed-order sum as linv above
      for (int w = 0; w < kWarps; ++w) l += wstat[w * GMAX + g];
      x = x / fmaxf(l, 1e-30f);
    }
    a.out[((size_t)b * H + h0 + g) * hd + d] = __float2bfloat16_rn(x);
  }
}

// mass[b, j] = sum_h scratch[b, h, j] / H, heads summed in order.
__global__ void mass_kernel(const float* __restrict__ scratch,
                            float* __restrict__ mass, int B, int H, int S) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, j = idx % S;
  float x = 0.0f;
  for (int h = 0; h < H; ++h) x += scratch[((size_t)b * H + h) * S + j];
  mass[idx] = x / (float)H;
}

template <int PER, int GMAX, bool ALL_QUANT>
void launch(const Args& a, int B, bool select, bool mass, cudaStream_t st) {
  const int G = a.H / a.KV;
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * G * a.hd + kWarps * GMAX);
  const dim3 grid(B * a.KV), block(kThreads);
  if (select && mass)
    mqattn_kernel<PER, GMAX, true, true, ALL_QUANT>
        <<<grid, block, smem, st>>>(a);
  else if (select)
    mqattn_kernel<PER, GMAX, true, false, ALL_QUANT>
        <<<grid, block, smem, st>>>(a);
  else if (mass)
    mqattn_kernel<PER, GMAX, false, true, ALL_QUANT>
        <<<grid, block, smem, st>>>(a);
  else
    mqattn_kernel<PER, GMAX, false, false, ALL_QUANT>
        <<<grid, block, smem, st>>>(a);
}

template <int PER, bool ALL_QUANT>
void launch_per(const Args& a, int B, bool select, bool mass,
                cudaStream_t st) {
  if (a.H / a.KV == 1)
    launch<PER, 1, ALL_QUANT>(a, B, select, mass, st);
  else
    launch<PER, kMaxGroup, ALL_QUANT>(a, B, select, mass, st);
}

bool bad_shape(int B, int S, int H, int KV, int hd) {
  return B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || hd <= 0 ||
         hd > kMaxHd || H / KV > kMaxGroup;
}

// the attention launch, then (with a mass) the head sum of the scratch
template <bool ALL_QUANT>
int run(const Args& a, int B, int select, void* mass, cudaStream_t st) {
  const bool want_mass = mass != nullptr;
  const int per = (a.hd + 31) / 32;
  if (per == 1)
    launch_per<1, ALL_QUANT>(a, B, select != 0, want_mass, st);
  else if (per == 2)
    launch_per<2, ALL_QUANT>(a, B, select != 0, want_mass, st);
  else
    launch_per<4, ALL_QUANT>(a, B, select != 0, want_mass, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !want_mass) return (int)err;
  mass_kernel<<<(B * a.S + 255) / 256, 256, 0, st>>>(
      a.scratch, static_cast<float*>(mass), B, a.H, a.S);
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces (loaded with ctypes).  Each returns cudaGetLastError()
// after the launches (0 = launched), or -1 for shapes the kernel does
// not take (hd > 128, H not a multiple of KV, G = H / KV > 8).  `mass`
// may be null: then no mass is written and the second launch is
// skipped.
extern "C" int decode_mqattn(const void* q, const void* k, const void* v,
                             const void* kq, const void* vq, const void* ks,
                             const void* vs, const void* qmask,
                             const void* n_valid, void* out, void* scratch,
                             void* mass, int B, int S, int H, int KV, int hd,
                             int window, int n_sinks, float scale,
                             int select, void* stream) {
  if (bad_shape(B, S, H, KV, hd)) return -1;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.kq = static_cast<const int8_t*>(kq);
  a.vq = static_cast<const int8_t*>(vq);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.qmask = static_cast<const uint8_t*>(qmask);
  a.n_valid = static_cast<const int*>(n_valid);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.n_sinks = n_sinks;
  a.scale = scale;
  return run<false>(a, B, select, mass, static_cast<cudaStream_t>(stream));
}

// The all-int8 cache: no bf16 k/v and no quant mask.
extern "C" int decode_qattn(const void* q, const void* kq, const void* vq,
                            const void* ks, const void* vs,
                            const void* n_valid, void* out, void* scratch,
                            void* mass, int B, int S, int H, int KV, int hd,
                            int window, int n_sinks, float scale, int select,
                            void* stream) {
  if (bad_shape(B, S, H, KV, hd)) return -1;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = nullptr;
  a.v = nullptr;
  a.kq = static_cast<const int8_t*>(kq);
  a.vq = static_cast<const int8_t*>(vq);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.qmask = nullptr;
  a.n_valid = static_cast<const int*>(n_valid);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.n_sinks = n_sinks;
  a.scale = scale;
  return run<true>(a, B, select, mass, static_cast<cudaStream_t>(stream));
}
