// Decode attention for Hopper (sm_90a) over a mixed or an all-int8
// cache.  Mixed: one new token per row attends a cache whose positions
// live either in the bf16 window or in int8 quant-resident segments
// (per-(token, kv-head) fp32 scales), selected per position by
// quant_mask.  All-int8: every position is int8 codes and scales, with
// no bf16 cache and no mask.  Either optionally also emits the Eq.-1
// per-key attention mass that feeds the Eq.-3 bit plan.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/decode_qattn.py  decode_mqattn (_mixed_kernel)
//   src/repro/kernels/decode_qattn.py  decode_qattn  (_kernel)
// and adds what the reference computes beside them on its jnp paths
// (src/repro/models/common.py mixed_decode_attention and
// decode_attention with scales): the per-key mass and the bf16-rounded
// p of the plain select path.  The plain PyTorch versions are
// src/repro_torch/kernels/ref.py decode_mqattn_plain and
// decode_qattn_plain.
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
// head h reads kv-head h / G, G = H / KV.  Two forms:
//   fused  — out = bf16(sum_j exp(s_j - m) v_j / max(l, 1e-30)), PV fp32;
//   select — p = exp(s - m) / l rounded to bf16, PV accumulated in fp32,
//            out = bf16(sum).
// mass (B,S) = sum over heads of exp(s - m) / max(l, 1e-30), over H.
//
// Design: split S (flash-decoding), one design for both caches; the
// all-int8 cache runs the same kernels instantiated with ALL_QUANT
// (named dq_* so that a profile tells the two caches apart).  The host
// plan (split_plan, and plan() in kernels/decode_mqattn.py) cuts S into
// n_splits splits of at least 64 and at most 1024 keys so that the
// (n_splits, KV, B) grid holds up to four blocks per SM: 8 splits of 64
// keys, 256 blocks, at (1, 512, 32, 32, 128); 16 of 256 keys, 512
// blocks, at (1, 4096, …); 4 of 1024 keys, 512 blocks, at (4, 4096, …).
// A block of 128 threads is 8 half-warps; a half-warp takes a key row
// at a time, lane t the elements [8t, 8t + 8) (one 16 B load of 8 bf16,
// or one 8 B load of 8 int8 codes and the row's scale), with 8 rows in
// flight per half-warp, 64 per block; the next round's loads are
// issued before this one is used.  The mixed cache's first round loads
// both forms of each row while the split's quant mask comes into shared
// memory.  The all-int8 cache loads only codes and scales and reads no
// mask: about 8.5 KB in flight per block where the bf16 rows have 16 KB,
// but its split kernels need at most 128 registers at G = 1, so four
// blocks share an SM and the 512 blocks at (4, 4096, …) run in one
// wave.  (16 rows in flight per half-warp took 168 registers, three
// blocks per SM and two waves; 16 codes a lane would need 16
// accumulators per head, 128 registers at G = 8.)  Codes become fp32 by a byte permute and an
// exact subtraction (code_f32), not a quarter-rate conversion.  Decode
// at G <= 8 is a matrix-vector product, so the dots run on CUDA cores
// (a half-warp shuffle sum per head).  A split's scores stay in shared
// memory.  Launches:
//   select: (1) scores, the split's (m_i, l_i) per head, and the scores
//           to the (B,H,S) scratch; (2) every split's stats combined in
//           split order into the global (m, l), p / l rounded to bf16,
//           the split's PV partial, and p / l back into the scratch for
//           the mass; (3) the partials summed in split order, and the
//           mass summed over heads in order;
//   fused:  (1) scores, the split's (m_i, l_i), p = exp(s - m_i) and
//           the split's PV partial; (3) the partials rescaled
//           by exp(m_i - m) and summed in split order, over l; the mass
//           from the scores and the combined (m, l).
// Every reduction runs in a fixed order and no atomics are used, so
// reruns are bit-identical.
//
// Bound.  Memory: the valid keys' bytes, n_valid * KV * (2 hd * 2) at
// bf16 positions and n_valid * KV * (2 hd + 8) at quant positions (all
// of them in the all-int8 cache), per layer; the operations (4 H hd per
// valid key) are far below the fp32 rate.  At (1, 512, 32, 32, 128)
// that is about 2 us; the kernels are bound by the latency of two or
// three short dependent launches and of each block's one round of
// loads; at S = 4096 by the bytes each block keeps in flight through
// registers.  Reading K/V through the page tables instead of the
// gathered view is later work.
//
// Numerics: expf (accurate, no --use_fast_math), IEEE division
// (-prec-div=true), __float2bfloat16_rn for every bf16 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 128;
constexpr int kMaxGroup = 8;
// the port's NEG_INF: -0.7 * float32 max computed in double, then cast
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

constexpr int kSplitThreads = 128;                  // 8 half-warps
constexpr int kHalfWarps = kSplitThreads / 16;
constexpr int kRowsInFlight = 8;                    // a half-warp's keys
constexpr int kMinSplitKeys = 64;
constexpr int kMaxSplitKeys = 1024;                 // scores in smem
constexpr int kTargetBlocks = 4 * 132;              // four blocks per SM
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool key_valid(int j, int nv, int window,
                                          int n_sinks) {
  return j < nv && (window <= 0 || j >= nv - window || j < n_sinks);
}

bool bad_shape(int B, int S, int H, int KV, int hd) {
  return B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || hd <= 0 ||
         hd > kMaxHd || H / KV > kMaxGroup;
}

struct SplitArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;    // null in the all-int8 cache
  const __nv_bfloat16* v;    // null in the all-int8 cache
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  const uint8_t* qmask;      // null in the all-int8 cache
  const int* n_valid;
  __nv_bfloat16* out;
  float* sc;       // (B, H, S) scores, then (select, mass) p / l
  float* stats;    // (B, H, n_splits, 2) a split's (m, l)
  float* partial;  // (B, H, n_splits, hd) a split's PV
  float* mass;     // (B, S) or null
  int S, H, KV, G, hd, window, n_sinks, n_splits, split_len, vec,
      write_scores;
  float scale;
};

// n_splits and keys per split: up to four blocks per SM (all resident at
// once) where S allows at least 64 keys a split, at most 1024 keys a
// split (a split's scores stay in shared memory).
// kernels/decode_mqattn.py plan() is the same rule.
int split_plan(int B, int S, int KV, int* len) {
  const int by_card = kTargetBlocks / (B * KV);
  const int by_keys = S / kMinSplitKeys;
  int n = max(1, min(by_card, by_keys));
  n = max(n, (S + kMaxSplitKeys - 1) / kMaxSplitKeys);
  *len = (S + n - 1) / n;
  return (S + *len - 1) / *len;
}

// One cache row's 8 elements [d0, d0 + 8): 16 B of bf16 (w), or 8 int8
// codes (w8) and the row's scale; the first round of a block loads both
// before it knows which the position holds.  The all-int8 cache's row
// has codes and scale only.
template <bool AQ>
struct Raw {
  uint4 w;
  uint2 w8;
  float sc;
};
template <>
struct Raw<true> {
  uint2 w8;
  float sc;
};

// a half-warp's rows of one round of keys, loaded but not yet unpacked
template <bool AQ>
struct Rows {
  static constexpr int N = kRowsInFlight;
  static constexpr int kChunk = kHalfWarps * N;  // a block's keys a round
  Raw<AQ> r[N];
  bool ok[N];  // a valid key
  bool qt[N];  // at a quant position (mixed cache)
};

// The split kernels' shared memory: a split's scores (then p, then the
// PV partials of the half-warps), the block reductions, the combined
// (m, l) and (mixed cache) the split's quant mask.
struct SplitSmem {
  float* ssm;    // [G][split_len], later [kHalfWarps][G][hd]
  float* buf;    // [kSplitThreads / 32][GMAX]
  float* ml;     // [G] m, [G] l
  uint8_t* qms;  // [split_len]
};

__host__ __device__ inline int ssm_floats(int G, int L, int hd) {
  return max(G * L, kHalfWarps * G * hd);
}

__device__ __forceinline__ SplitSmem split_smem(float* sm, const SplitArgs& a,
                                                int gmax) {
  SplitSmem s;
  s.ssm = sm;
  s.buf = sm + ssm_floats(a.G, a.split_len, a.hd);
  s.ml = s.buf + (kSplitThreads / 32) * gmax;
  s.qms = reinterpret_cast<uint8_t*>(s.ml + 2 * a.G);
  return s;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// the loads of one row; `bf`, `q8`: which of its two forms to read
template <bool AQ>
__device__ __forceinline__ Raw<AQ> fetch(const __nv_bfloat16* __restrict__ x,
                                         const int8_t* __restrict__ xq,
                                         const float* __restrict__ xs,
                                         size_t row, int hd, int d0, bool bf,
                                         bool q8, bool vec) {
  Raw<AQ> r{};
  if (d0 >= hd) return r;
  if (q8) r.sc = xs[row];
  if (vec) {
    if (q8) r.w8 = *reinterpret_cast<const uint2*>(xq + row * hd + d0);
    if constexpr (!AQ)
      if (bf) r.w = *reinterpret_cast<const uint4*>(x + row * hd + d0);
  } else {  // hd not a multiple of 8: element by element, zeros past hd
    uint32_t w[4] = {0u, 0u, 0u, 0u}, w8[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (d0 + i >= hd) break;
      if (q8)
        w8[i / 4] |= (uint32_t)(uint8_t)xq[row * hd + d0 + i] << (8 * (i % 4));
      if constexpr (!AQ)
        if (bf)
          w[i / 2] |= (uint32_t)__bfloat16_as_ushort(x[row * hd + d0 + i])
                      << (16 * (i % 2));
    }
    if constexpr (!AQ) r.w = make_uint4(w[0], w[1], w[2], w[3]);
    r.w8 = make_uint2(w8[0], w8[1]);
  }
  return r;
}

// code i of the 4 int8 codes in w as fp32, exactly (float)code: the
// biased byte (code + 128) under the exponent of 2^23, minus 2^23 + 128
// (a byte permute and an add: no quarter-rate int-to-float conversion)
__device__ __forceinline__ float code_f32(uint32_t w, int i) {
  const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4b000000u, 0x7440 | i);
  return __uint_as_float(u) - 8388736.0f;
}

// the 8 values as fp32.  Mixed cache: bf16, or bf16(code * scale) at a
// quant position.  All-int8 cache: code * scale, rounded to bf16 when
// ROUND (the select form), kept in fp32 otherwise (the fused form).
template <bool AQ, bool ROUND>
__device__ __forceinline__ void unpack(const Raw<AQ>& r, bool quant,
                                       float (&f)[8]) {
  const uint32_t w8[2] = {r.w8.x, r.w8.y};
  if constexpr (AQ) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = code_f32(w8[i / 4], i % 4) * r.sc;
      f[i] = ROUND ? bf16_round(y) : y;
    }
  } else {
    const uint32_t w[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (quant) {
        f[i] = bf16_round(code_f32(w8[i / 4], i % 4) * r.sc);
      } else {
        f[i] = __uint_as_float(((w[i / 2] >> (16 * (i % 2))) & 0xffffu)
                               << 16);
      }
    }
  }
}

// issue the loads of a half-warp's keys c0 + u * kHalfWarps + hw of
// [c0, s1), elements [d0, d0 + 8); invalid keys read as zeros.  Mixed
// cache: with `first` the quant mask is not read yet: both forms of each
// row load, and mark_quant picks one after the mask has reached shared
// memory.  All-int8 cache: codes and scales only, no mask.
template <bool AQ>
__device__ __forceinline__ void issue_rows(const SplitArgs& a,
                                           const __nv_bfloat16* x,
                                           const int8_t* xq, const float* xs,
                                           const uint8_t* qms, int b, int kvh,
                                           int s0, int c0, int s1, int nv,
                                           bool first, Rows<AQ>& R) {
  const int hw = threadIdx.x / 16, d0 = (threadIdx.x % 16) * 8;
#pragma unroll
  for (int u = 0; u < Rows<AQ>::N; ++u) {
    const int j = c0 + u * kHalfWarps + hw;
    const size_t row = ((size_t)b * a.S + j) * a.KV + kvh;
    R.ok[u] = j < s1 && key_valid(j, nv, a.window, a.n_sinks);
    if constexpr (AQ) {
      R.qt[u] = true;  // every position (unpack does not read it)
      R.r[u] = R.ok[u] ? fetch<true>(nullptr, xq, xs, row, a.hd, d0, false,
                                     true, a.vec != 0)
                       : Raw<true>{};
    } else {
      R.qt[u] = R.ok[u] && !first && qms[j - s0] != 0;
      R.r[u] = R.ok[u] ? fetch<false>(x, xq, xs, row, a.hd, d0,
                                      first || !R.qt[u], first || R.qt[u],
                                      a.vec != 0)
                       : Raw<false>{};
    }
  }
}

__device__ __forceinline__ void mark_quant(Rows<false>& R, const uint8_t* qms,
                                           int s0, int c0) {
  const int hw = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < Rows<false>::N; ++u)
    R.qt[u] = R.ok[u] && qms[c0 + u * kHalfWarps + hw - s0] != 0;
}

// the split's quant mask into shared memory, four loads in flight
__device__ __forceinline__ void load_qmask(const SplitArgs& a, uint8_t* qms,
                                           int b, int s0, int n) {
  const uint8_t* qm = a.qmask + (size_t)b * a.S + s0;
  for (int j0 = threadIdx.x; j0 < n; j0 += 4 * kSplitThreads) {
    uint8_t t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = j0 + i * kSplitThreads;
      t[i] = jj < n ? qm[jj] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (j0 + i * kSplitThreads < n) qms[j0 + i * kSplitThreads] = t[i];
  }
}

// max (MAX) or sum of x over the block's threads in a fixed order; every
// thread gets the result
template <int GMAX, bool MAX>
__device__ __forceinline__ void block_reduce(float (&x)[GMAX], int G,
                                             float* buf) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], o);
      x[g] = MAX ? fmaxf(x[g], y) : x[g] + y;
    }
    if (lane == 0) buf[warp * GMAX + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    float r = buf[g];
    for (int w = 1; w < kSplitThreads / 32; ++w)
      r = MAX ? fmaxf(r, buf[w * GMAX + g]) : r + buf[w * GMAX + g];
    x[g] = r;
  }
  __syncthreads();
}

// acc[g] += p[g][j] v_j over the split's valid keys (p in shared memory;
// `cur` holds the first round's V rows, issued and marked), one round's
// loads in flight while the last is used; then the half-warps' sums
// added in order into the split's partial
template <int GMAX, bool AQ, bool ROUND>
__device__ __forceinline__ void split_pv(const SplitArgs& a,
                                         const SplitSmem& sh, Rows<AQ>& cur,
                                         int b, int kvh, int split, int s0,
                                         int s1, int nv) {
  const int G = a.G, hd = a.hd, L = a.split_len, tid = threadIdx.x;
  const int hw = tid / 16, d0 = (tid % 16) * 8;
  float acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.0f;
  for (int c0 = s0; c0 < s1; c0 += Rows<AQ>::kChunk) {
    Rows<AQ> nxt;
    if (c0 + Rows<AQ>::kChunk < s1)
      issue_rows<AQ>(a, a.v, a.vq, a.vs, sh.qms, b, kvh, s0,
                     c0 + Rows<AQ>::kChunk, s1, nv, false, nxt);
#pragma unroll
    for (int u = 0; u < Rows<AQ>::N; ++u) {
      if (!cur.ok[u]) continue;
      float f[8];
      unpack<AQ, ROUND>(cur.r[u], cur.qt[u], f);
      const int jj = c0 + u * kHalfWarps + hw - s0;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float p = sh.ssm[g * L + jj];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] += p * f[i];
      }
    }
    cur = nxt;
  }
  __syncthreads();      // the partials below overwrite the scores
  float* red = sh.ssm;  // [kHalfWarps][G][hd]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (d0 + i < hd) red[(hw * G + g) * hd + d0 + i] = acc[g][i];
  }
  __syncthreads();
  const int h0 = kvh * G;
  for (int e = tid; e < G * hd; e += kSplitThreads) {
    float x = 0.0f;
    for (int w = 0; w < kHalfWarps; ++w) x += red[w * G * hd + e];
    const int g = e / hd, d = e % hd;
    a.partial[(((size_t)b * a.H + h0 + g) * a.n_splits + split) * hd + d] = x;
  }
}

// Launch 1, one block per (split, kv-head, row): the split's scores into
// shared memory (and, for the select form or the mass, to sc; -inf at
// invalid keys) and its (m, l) per head; the fused form also turns them
// into p = exp(s - m) and writes the split's PV partial.
template <int GMAX, bool FUSED, bool AQ>
__device__ __forceinline__ void split_scores(const SplitArgs& a) {
  // the mixed cache attends bf16(code * scale); the all-int8 cache
  // rounds only in the select form
  constexpr bool kRound = !AQ || !FUSED;
  constexpr int kChunk = Rows<AQ>::kChunk;
  extern __shared__ float sm[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.G, S = a.S, L = a.split_len, h0 = kvh * G;
  const int s0 = split * L, s1 = min(S, s0 + L), n = s1 - s0;
  const int tid = threadIdx.x, hw = tid / 16, d0 = (tid % 16) * 8;
  const int nv = min(a.n_valid[b], S);
  const SplitSmem sh = split_smem(sm, a, GMAX);

  float qr[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[g][i] = (g < G && d0 + i < a.hd)
                     ? __bfloat162float(
                           a.q[((size_t)b * a.H + h0 + g) * a.hd + d0 + i])
                     : 0.0f;
  Rows<AQ> cur;
  issue_rows<AQ>(a, a.k, a.kq, a.ks, sh.qms, b, kvh, s0, s0, s1, nv, true,
                 cur);
  if constexpr (!AQ) {
    load_qmask(a, sh.qms, b, s0, n);
    __syncthreads();
    mark_quant(cur, sh.qms, s0, s0);
  }
  for (int c0 = s0; c0 < s1; c0 += kChunk) {
    Rows<AQ> nxt;
    if (c0 + kChunk < s1)
      issue_rows<AQ>(a, a.k, a.kq, a.ks, sh.qms, b, kvh, s0, c0 + kChunk, s1,
                     nv, false, nxt);
#pragma unroll
    for (int u = 0; u < Rows<AQ>::N; ++u) {
      if (c0 + u * kHalfWarps >= s1) break;  // the block's rows end here
      const int j = c0 + u * kHalfWarps + hw;
      float f[8];
      unpack<AQ, kRound>(cur.r[u], cur.qt[u], f);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) x += qr[g][i] * f[i];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        const float s = cur.ok[u] ? x * a.scale : __int_as_float(0xff800000);
        if (tid % 16 == 0 && j < s1) {
          sh.ssm[g * L + j - s0] = s;
          if (a.write_scores) a.sc[((size_t)b * a.H + h0 + g) * S + j] = s;
        }
      }
    }
    cur = nxt;
  }
  // fused: the V rows of the first round load during the reductions
  if (FUSED) {
    issue_rows<AQ>(a, a.v, a.vq, a.vs, sh.qms, b, kvh, s0, s0, s1, nv, false,
                   cur);
  }
  __syncthreads();
  float m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    if (g < G)
      for (int jj = tid; jj < n; jj += kSplitThreads)
        m[g] = fmaxf(m[g], sh.ssm[g * L + jj]);
  }
  block_reduce<GMAX, true>(m, G, sh.buf);
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    l[g] = 0.0f;
    if (g < G)
      for (int jj = tid; jj < n; jj += kSplitThreads) {
        const float p = expf(sh.ssm[g * L + jj] - m[g]);  // 0 at -inf
        if (FUSED) sh.ssm[g * L + jj] = p;
        l[g] += p;
      }
  }
  block_reduce<GMAX, false>(l, G, sh.buf);
  if (tid == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float* st =
          a.stats + (((size_t)b * a.H + h0 + g) * a.n_splits + split) * 2;
      st[0] = m[g];
      st[1] = l[g];
    }
  if (FUSED) split_pv<GMAX, AQ, kRound>(a, sh, cur, b, kvh, split, s0, s1, nv);
}

constexpr int kBatch = 16;  // loads issued together in the combining loops

// the global (m, max(l, 1e-30)) of head h of row b from every split's
// stats, in split order, kBatch splits' loads at a time (one pass when
// n_splits <= kBatch)
__device__ __forceinline__ float2 head_stats(const SplitArgs& a, int b,
                                             int h) {
  const float* st = a.stats + ((size_t)b * a.H + h) * a.n_splits * 2;
  const int ns = a.n_splits;
  float m = kNegInf, l = 0.0f, v[kBatch], w[kBatch];
  for (int i0 = 0; i0 < ns; i0 += kBatch) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = i0 + k < ns ? st[2 * (i0 + k)] : kNegInf;
      w[k] = i0 + k < ns ? st[2 * (i0 + k) + 1] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) m = fmaxf(m, v[k]);
  }
  for (int i0 = 0; i0 < ns; i0 += kBatch) {
    if (ns > kBatch)  // else v, w still hold the one batch
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        v[k] = i0 + k < ns ? st[2 * (i0 + k)] : kNegInf;
        w[k] = i0 + k < ns ? st[2 * (i0 + k) + 1] : 0.0f;
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i0 + k < ns) l += w[k] * expf(v[k] - m);
  }
  return make_float2(m, fmaxf(l, 1e-30f));
}

// Launch 2 of the select form: p / l with the global (m, l), rounded to
// bf16, and the split's PV partial; with the mass, p / l back into sc.
// The first round of V rows, the scores, the quant mask and the stats
// all load at once.  Both caches round the values to bf16 here.
template <int GMAX, bool AQ>
__device__ __forceinline__ void split_select_pv(const SplitArgs& a) {
  extern __shared__ float sm[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.G, S = a.S, L = a.split_len, h0 = kvh * G;
  const int s0 = split * L, s1 = min(S, s0 + L), n = s1 - s0;
  const int tid = threadIdx.x;
  const int nv = min(a.n_valid[b], S);
  const SplitSmem sh = split_smem(sm, a, GMAX);
  Rows<AQ> cur;
  issue_rows<AQ>(a, a.v, a.vq, a.vs, sh.qms, b, kvh, s0, s0, s1, nv, true,
                 cur);
  for (int e = tid; e < G * n; e += kSplitThreads) {
    const int g = e / n, jj = e % n;
    cp_async4(sh.ssm + g * L + jj, a.sc + ((size_t)b * a.H + h0 + g) * S +
                                       s0 + jj);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if constexpr (!AQ) load_qmask(a, sh.qms, b, s0, n);
  if (tid < G) {
    const float2 x = head_stats(a, b, h0 + tid);
    sh.ml[tid] = x.x;
    sh.ml[G + tid] = x.y;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if constexpr (!AQ) mark_quant(cur, sh.qms, s0, s0);
  for (int e = tid; e < G * n; e += kSplitThreads) {
    const int g = e / n, jj = e % n;
    const float pn = expf(sh.ssm[g * L + jj] - sh.ml[g]) / sh.ml[G + g];
    if (a.mass != nullptr)  // 0 at -inf
      a.sc[((size_t)b * a.H + h0 + g) * S + s0 + jj] = pn;
    sh.ssm[g * L + jj] = bf16_round(pn);
  }
  __syncthreads();
  split_pv<GMAX, AQ, true>(a, sh, cur, b, kvh, split, s0, s1, nv);
}

// Last launch, grid (out blocks + mass blocks, B), 8 warps.  An out
// block: 256 elements of out = the splits' partials summed in split
// order (fused: each times exp(m_i - m), then over l).  A mass block: 32
// keys' mass = p / l summed over heads (0 at -inf), warp w taking every
// 8th head in order, then the 8 partials in order, over H.
template <bool SELECT>
__device__ __forceinline__ void combine(const SplitArgs& a, int out_blocks) {
  extern __shared__ float sm[];  // [H] m, [H] l (fused), [8][32] mass
  const int b = blockIdx.y, H = a.H, hd = a.hd, ns = a.n_splits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool out_block = (int)blockIdx.x < out_blocks;
  float* part = sm + 2 * H;
  if (!SELECT)
    for (int h = tid; h < H; h += kCombineThreads) {
      const float2 x = head_stats(a, b, h);
      sm[h] = x.x;
      sm[H + h] = x.y;
    }
  __syncthreads();
  if (out_block) {
    const int e = blockIdx.x * kCombineThreads + tid;
    if (e >= H * hd) return;
    const int h = e / hd, d = e % hd;
    const float* p = a.partial + ((size_t)b * H + h) * ns * hd + d;
    const float* st = a.stats + ((size_t)b * H + h) * ns * 2;
    float x = 0.0f;
    for (int i0 = 0; i0 < ns; i0 += kBatch) {
      float v[kBatch], f[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool in = i0 + k < ns;
        v[k] = in ? p[(size_t)(i0 + k) * hd] : 0.0f;
        f[k] = SELECT || !in ? 1.0f : expf(st[2 * (i0 + k)] - sm[h]);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (i0 + k < ns) x += SELECT ? v[k] : v[k] * f[k];
    }
    a.out[((size_t)b * H + h) * hd + d] =
        __float2bfloat16_rn(SELECT ? x : x / sm[H + h]);
    return;
  }
  const int j = (blockIdx.x - out_blocks) * 32 + lane;
  float x = 0.0f;
  constexpr int kWarpsC = kCombineThreads / 32;
  if (j < a.S)
    for (int h0 = warp; h0 < H; h0 += kWarpsC * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int h = h0 + k * kWarpsC;
        v[k] = h < H ? a.sc[((size_t)b * H + h) * a.S + j] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int h = h0 + k * kWarpsC;
        if (h < H) x += SELECT ? v[k] : expf(v[k] - sm[h]) / sm[H + h];
      }
    }
  part[warp * 32 + lane] = x;
  __syncthreads();
  if (warp == 0 && j < a.S) {
    float y = 0.0f;
    for (int w = 0; w < kWarpsC; ++w) y += part[w * 32 + lane];
    a.mass[(size_t)b * a.S + j] = y / (float)H;
  }
}

// The kernels, by name: mq_* over the mixed cache (decode_mqattn), dq_*
// over the all-int8 cache (decode_qattn).
template <int GMAX, bool FUSED>
__global__ void __launch_bounds__(kSplitThreads)
    mq_split_kernel(const SplitArgs a) {
  split_scores<GMAX, FUSED, false>(a);
}
template <int GMAX>
__global__ void __launch_bounds__(kSplitThreads)
    mq_split_pv_kernel(const SplitArgs a) {
  split_select_pv<GMAX, false>(a);
}
template <bool SELECT>
__global__ void __launch_bounds__(kCombineThreads)
    mq_combine_kernel(const SplitArgs a, int out_blocks) {
  combine<SELECT>(a, out_blocks);
}
template <int GMAX, bool FUSED>
__global__ void __launch_bounds__(kSplitThreads)
    dq_split_kernel(const SplitArgs a) {
  split_scores<GMAX, FUSED, true>(a);
}
template <int GMAX>
__global__ void __launch_bounds__(kSplitThreads)
    dq_split_pv_kernel(const SplitArgs a) {
  split_select_pv<GMAX, true>(a);
}
template <bool SELECT>
__global__ void __launch_bounds__(kCombineThreads)
    dq_combine_kernel(const SplitArgs a, int out_blocks) {
  combine<SELECT>(a, out_blocks);
}

template <int GMAX, bool AQ>
int run_split(const SplitArgs& a, int B, bool select, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)ssm_floats(a.G, a.split_len, a.hd) +
                       (kSplitThreads / 32) * GMAX + 2 * a.G) +
      (AQ ? 0 : a.split_len);  // the quant mask
  const dim3 grid(a.n_splits, a.KV, B);
  if (select) {
    if constexpr (AQ) {
      dq_split_kernel<GMAX, false><<<grid, kSplitThreads, smem, st>>>(a);
      dq_split_pv_kernel<GMAX><<<grid, kSplitThreads, smem, st>>>(a);
    } else {
      mq_split_kernel<GMAX, false><<<grid, kSplitThreads, smem, st>>>(a);
      mq_split_pv_kernel<GMAX><<<grid, kSplitThreads, smem, st>>>(a);
    }
  } else {
    if constexpr (AQ)
      dq_split_kernel<GMAX, true><<<grid, kSplitThreads, smem, st>>>(a);
    else
      mq_split_kernel<GMAX, true><<<grid, kSplitThreads, smem, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = kCombineThreads;
  const int out_blocks = (a.H * a.hd + per - 1) / per;
  const dim3 cgrid(out_blocks + (a.mass != nullptr ? (a.S + 31) / 32 : 0),
                   B);
  const size_t csmem = sizeof(float) * (2 * a.H + per);
  if constexpr (AQ) {
    if (select)
      dq_combine_kernel<true><<<cgrid, per, csmem, st>>>(a, out_blocks);
    else
      dq_combine_kernel<false><<<cgrid, per, csmem, st>>>(a, out_blocks);
  } else {
    if (select)
      mq_combine_kernel<true><<<cgrid, per, csmem, st>>>(a, out_blocks);
    else
      mq_combine_kernel<false><<<cgrid, per, csmem, st>>>(a, out_blocks);
  }
  return (int)cudaGetLastError();
}

// Both entries' arguments and the scratch: scores (B,H,S), stats
// (B,H,n_splits,2), partials (B,H,n_splits,hd).
SplitArgs split_args(const void* q, const void* k, const void* v,
                     const void* kq, const void* vq, const void* ks,
                     const void* vs, const void* qmask, const void* n_valid,
                     void* out, void* scratch, void* mass, int B, int S,
                     int H, int KV, int hd, int window, int n_sinks,
                     float scale, int select) {
  SplitArgs a;
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
  a.mass = static_cast<float*>(mass);
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hd = hd;
  a.window = window;
  a.n_sinks = n_sinks;
  a.n_splits = split_plan(B, S, KV, &a.split_len);
  a.vec = hd % 8 == 0;
  a.write_scores = select != 0 || mass != nullptr;
  a.scale = scale;
  a.sc = static_cast<float*>(scratch);
  a.stats = a.sc + (size_t)B * H * S;
  a.partial = a.stats + (size_t)B * H * a.n_splits * 2;
  return a;
}

}  // namespace

// C interfaces (loaded with ctypes).  Each returns cudaGetLastError()
// after the launches (0 = launched), or -1 for shapes the kernel does
// not take (hd > 128, H not a multiple of KV, G = H / KV > 8).  `mass`
// may be null: then no mass is written.  The scratch of either holds
// B * H * (S + n_splits * (2 + hd)) floats.
extern "C" int decode_mqattn(const void* q, const void* k, const void* v,
                             const void* kq, const void* vq, const void* ks,
                             const void* vs, const void* qmask,
                             const void* n_valid, void* out, void* scratch,
                             void* mass, int B, int S, int H, int KV, int hd,
                             int window, int n_sinks, float scale,
                             int select, void* stream) {
  if (bad_shape(B, S, H, KV, hd)) return -1;
  const SplitArgs a =
      split_args(q, k, v, kq, vq, ks, vs, qmask, n_valid, out, scratch, mass,
                 B, S, H, KV, hd, window, n_sinks, scale, select);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.G == 1 ? run_split<1, false>(a, B, select != 0, st)
                  : run_split<kMaxGroup, false>(a, B, select != 0, st);
}

// The split plan of both entries (kernels/decode_mqattn.py plan() is the
// same rule): n_splits; the wrappers size the scratch with it.
extern "C" int decode_mqattn_splits(int B, int S, int KV) {
  if (B <= 0 || S <= 0 || KV <= 0) return -1;
  int len;
  return split_plan(B, S, KV, &len);
}

// The all-int8 cache: no bf16 k/v and no quant mask.
extern "C" int decode_qattn(const void* q, const void* kq, const void* vq,
                            const void* ks, const void* vs,
                            const void* n_valid, void* out, void* scratch,
                            void* mass, int B, int S, int H, int KV, int hd,
                            int window, int n_sinks, float scale, int select,
                            void* stream) {
  if (bad_shape(B, S, H, KV, hd)) return -1;
  const SplitArgs a =
      split_args(q, nullptr, nullptr, kq, vq, ks, vs, nullptr, n_valid, out,
                 scratch, mass, B, S, H, KV, hd, window, n_sinks, scale,
                 select);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.G == 1 ? run_split<1, true>(a, B, select != 0, st)
                  : run_split<kMaxGroup, true>(a, B, select != 0, st);
}
