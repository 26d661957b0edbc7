// Extend attention with the Eq.-1 key density for Hopper (sm_90a): the
// attention of serving's prefill-append (DenseModel.recompute) — queries
// at arbitrary positions q_pos over a whole cache bounded by seq_len,
// with an optional sliding window and sink tokens — fused with the
// per-key attention mass that drives the Eq.-3 bit plan.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/attn_density.py  attn_density pass 1 (_fwd) and
//                                      pass 2 (_mass)
// and generalizes them to what the reference's serving path computes
// beside them in jnp (src/repro/models/common.py gqa_attention under
// causal_window_mask(miss_pos, k) & (k < seq_len)).  The plain PyTorch
// version is src/repro_torch/kernels/ref.py attn_density_plain.
//
// The function.  q (B,Sq,H,hd) bf16; k, v (B,Sk,KV,hd) bf16; q_pos (Sq,)
// int32.  Key j is visible to query i when j <= q_pos[i], j < seq_len
// and, with a window, j > q_pos[i] - window or j < n_sinks.  Scores are
// fp32 dot products times 1/sqrt(hd); invisible keys take the finite
// NEG_INF = -0.7 FLT_MAX, so a query with no visible key is uniform over
// all Sk keys.  Query head h reads kv-head h / G, G = H / KV.  Two forms
// (template SERVED):
//   served — softmax p = exp(s - m) / l in fp32, p rounded to bf16
//            before PV (fp32 accumulation), out = bf16(sum); the mass
//            sums p over heads and queries (uniform rows included);
//   flash  — the Pallas kernel: out = bf16(sum_j exp(s_j - m) v_j /
//            max(l, 1e-30)), PV fp32; the mass sums p / max(l, 1e-30)
//            over visible (query, key) pairs only.
// density (B,Sk) = mass / (H * max(1, visible queries of the key)).
//
// Design.  One block of 256 threads per (b, kv-head, query tile).  A
// tile holds 64 (query, head) rows: 64 / G queries times the G heads of
// the group, so K/V rows are read once for the whole group.  Keys go in
// tiles of 64 through shared memory (K transposed, V row-major, both
// fp32); each thread computes a 4 x 4 block of scores and owns 4 rows x
// 8 head-dim columns of the PV accumulator.  The dots run on CUDA cores
// (simplicity first; mma.sync / wgmma is later work).  Key tiles that no
// row of the block can see (past the causal edge or seq_len, or wholly
// below every row's window and above the sinks) are skipped, unless a
// row of the block sees no key at all (then every tile counts, as its
// uniform p covers all Sk keys).  Passes over the keys:
//   served: (1) online row max m and row sum l; (2) p, its per-key
//           column sums, PV;
//   flash:  (1) online softmax with PV (the Pallas _fwd); (2), only with
//           the density, p / l and its column sums (the Pallas _mass).
// Each block writes its per-key column sums for its query tile to a
// (B, KV, n_tiles, Sk) scratch (zeroed first); a second small launch
// sums the scratch over tiles and kv-heads in a fixed order, counts
// each key's visible queries and divides.  No floating-point atomics:
// reruns are bit-identical, and so are the bit plans.
//
// Bound.  Bytes: q, the visible K/V rows and out once, about
// (Sq H + 2 n_keys KV + Sq H) hd * 2 bytes; operations: 4 hd per visible
// (row, key) pair (QK and PV multiply-adds) — 2 hd more per pair for the
// served form's and the density's second QK.  At serving's extend
// (64 queries, 32 heads, hd 128, seq_len <= 512) both are about a
// microsecond, and the kernel, with 32 blocks on 132 SMs and its dots on
// CUDA cores, is latency- and instruction-bound far above that.
//
// Numerics: expf (accurate, no --use_fast_math), IEEE division
// (-prec-div=true), __float2bfloat16_rn for every bf16 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // (query, head) rows of a block
constexpr int kKeys = 64;     // keys of a tile
constexpr int kLd = 65;       // padded leading dimension (no bank clash)
constexpr int kMaxHd = 128;
// the port's NEG_INF: -0.7 * float32 max computed in double, then cast
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* q_pos;
  __nv_bfloat16* out;
  float* part;  // (B, KV, n_tiles, Sk) per-tile key mass, or null
  int Sq, Sk, H, KV, hd, seq_len, window, n_sinks, bq, n_tiles;
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool visible(int j, int qp, int seq_len,
                                        int window, int n_sinks) {
  return j <= qp && j < seq_len &&
         (window <= 0 || j > qp - window || j < n_sinks);
}

// a query at qp sees at least one key of [0, min(qp, seq_len - 1, Sk - 1)]
__device__ __forceinline__ bool sees_a_key(int qp, int seq_len, int Sk,
                                           int window, int n_sinks) {
  const int hi = min(qp, min(seq_len, Sk) - 1);
  return hi >= 0 && (window <= 0 || hi > qp - window || n_sinks > 0);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <bool SERVED, bool MASS>
__global__ void __launch_bounds__(kThreads) attn_kernel(const Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, Sk = a.Sk, G = a.H / a.KV;
  const int tile = blockIdx.x % a.n_tiles;
  const int kvh = (blockIdx.x / a.n_tiles) % a.KV;
  const int b = blockIdx.x / (a.n_tiles * a.KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* Qs = smem;                    // [hd][kLd]: Qs[d * kLd + row]
  float* Ks = Qs + hd * kLd;           // [hd][kLd]: Ks[d * kLd + key]
  float* Vs = Ks + hd * kLd;           // [kKeys][hd]
  float* Ps = Vs + kKeys * hd;         // [kRows][kLd]
  float* m_s = Ps + kRows * kLd;       // row max
  float* l_s = m_s + kRows;            // row sum
  float* al_s = l_s + kRows;           // this tile's rescale factor
  int* qp_s = reinterpret_cast<int*>(al_s + kRows);  // query position
  int* act_s = qp_s + kRows;                         // row is a real row
  int* blk = act_s + kRows;            // any row empty, key end, min qp

  // ---- rows: (query, head) = (row / G, row % G) of this tile ------- //
  if (tid < kRows) {
    const int qi = tid / G, qidx = tile * a.bq + qi;
    const int act = qi < a.bq && qidx < a.Sq;
    act_s[tid] = act;
    qp_s[tid] = act ? a.q_pos[qidx] : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  for (int e = tid; e < kRows * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int qi = r / G, qidx = tile * a.bq + qi;
    float x = 0.0f;
    if (qi < a.bq && qidx < a.Sq)
      x = __bfloat162float(
          a.q[(((size_t)b * a.Sq + qidx) * a.H + kvh * G + r % G) * hd + d]);
    Qs[d * kLd + r] = x;
  }
  __syncthreads();
  if (tid == 0) {
    int empty = 0, kend = 0, qmin = 0x7fffffff;
    for (int r = 0; r < kRows; ++r) {
      if (!act_s[r]) continue;
      const int qp = qp_s[r];
      empty |= !sees_a_key(qp, a.seq_len, Sk, a.window, a.n_sinks);
      kend = max(kend, min(qp, min(a.seq_len, Sk) - 1) + 1);
      qmin = min(qmin, qp);
    }
    blk[0] = empty;
    blk[1] = empty ? Sk : kend;
    blk[2] = qmin;
  }
  __syncthreads();
  const int kend = blk[1], qmin = blk[2];
  const bool all_tiles = blk[0] != 0;
  // a tile no row of the block can see: wholly below every row's window
  // and at or above the sinks (tiles past kend are not walked at all)
  auto skip = [&](int k0) {
    return !all_tiles && a.window > 0 && k0 >= a.n_sinks &&
           k0 + kKeys - 1 <= qmin - a.window;
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  // K (and V) tile k0 into shared memory, zero past Sk
  auto load_tile = [&](int k0, bool with_v) {
    for (int e = tid; e < kKeys * hd; e += kThreads) {
      const int j = e / hd, d = e % hd, key = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < Sk) {
        const size_t o = (((size_t)b * Sk + key) * a.KV + kvh) * hd + d;
        kx = __bfloat162float(a.k[o]);
        if (with_v) vx = __bfloat162float(a.v[o]);
      }
      Ks[d * kLd + j] = kx;
      if (with_v) Vs[j * hd + d] = vx;
    }
  };
  // masked scores of rows ty + 16 i, keys tx + 16 c into Ps; keys past
  // Sk get -inf (p exactly 0, never the max)
  auto scores = [&](int k0) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[d * kLd + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[d * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] += qv[i] * kv[c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = qp_s[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        float x;
        if (key >= Sk)
          x = __int_as_float(0xff800000);  // -inf
        else if (visible(key, qp, a.seq_len, a.window, a.n_sinks))
          x = s[i][c] * a.scale;
        else
          x = kNegInf;
        Ps[r * kLd + tx + 16 * c] = x;
      }
    }
  };
  // online (m, l) update of row tid / 4 over this tile; with keep_p the
  // tile's exp(s - m_new) replaces the scores (the flash form's PV)
  auto row_stats = [&](bool keep_p) {
    const int r = tid / 4, part = tid % 4;
    float* pr = Ps + r * kLd + part * 16;
    float mx = kNegInf;
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, pr[j]);
    mx = quad_max(mx);
    const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
    float sum = 0.0f;
    for (int j = 0; j < 16; ++j) {
      const float p = expf(pr[j] - m_new);
      if (keep_p) pr[j] = p;
      sum += p;
    }
    sum = quad_sum(sum);
    __syncwarp();
    if (part == 0) {
      const float alpha = expf(m_old - m_new);
      al_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
    }
  };
  // acc += P V over the tile (P rounded to bf16 in the served form)
  auto pv = [&](bool rescale) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (rescale) {
        const float al = al_s[r];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= al;
      }
    }
    for (int j = 0; j < kKeys; ++j) {
      float pj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kLd + j];
        pj[i] = SERVED ? bf16_round(p) : p;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = tx + 16 * c;
        const float vx = d < hd ? Vs[j * hd + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pj[i] * vx;
      }
    }
  };
  // column sums of the real rows of Ps into this tile's scratch row
  auto mass = [&](int k0) {
    const int c = tid / 4, part = tid % 4;
    float x = 0.0f;
    for (int r = part * 16; r < part * 16 + 16; ++r)
      if (act_s[r]) x += Ps[r * kLd + c];
    x = quad_sum(x);
    if (part == 0 && k0 + c < Sk)
      a.part[(((size_t)b * a.KV + kvh) * a.n_tiles + tile) * Sk + k0 + c] =
          x;
  };

  // ---- pass 1 ------------------------------------------------------- //
  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    if (skip(k0)) continue;
    load_tile(k0, !SERVED);
    __syncthreads();
    scores(k0);
    __syncthreads();
    row_stats(!SERVED);
    __syncthreads();
    if (!SERVED) {
      pv(true);
      __syncthreads();
    }
  }

  // ---- pass 2 ------------------------------------------------------- //
  if (SERVED || MASS) {
    for (int k0 = 0; k0 < kend; k0 += kKeys) {
      if (skip(k0)) continue;
      load_tile(k0, SERVED);
      __syncthreads();
      scores(k0);
      __syncthreads();
      {  // p = exp(s - m) / l (flash: only where visible)
        const int r = tid / 4, part = tid % 4;
        const float m = m_s[r], l = fmaxf(l_s[r], 1e-30f);
        float* pr = Ps + r * kLd + part * 16;
        for (int j = 0; j < 16; ++j) {
          const float s = pr[j];
          pr[j] = (SERVED || s != kNegInf) ? expf(s - m) / l : 0.0f;
        }
      }
      __syncthreads();
      if (MASS) mass(k0);
      if (SERVED) pv(false);
      __syncthreads();
    }
  }

  // ---- store -------------------------------------------------------- //
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (!act_s[r]) continue;
    const int qidx = tile * a.bq + r / G;
    const float lsafe = SERVED ? 1.0f : fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* o =
        a.out + (((size_t)b * a.Sq + qidx) * a.H + kvh * G + r % G) * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx + 16 * c;
      if (d < hd)
        o[d] = __float2bfloat16_rn(SERVED ? acc[i][c] : acc[i][c] / lsafe);
    }
  }
}

// density[b, j] = sum over kv-heads and query tiles of part, in order,
// over H * max(1, number of queries that see key j)
__global__ void density_kernel(const float* __restrict__ part,
                               const int* __restrict__ q_pos,
                               float* __restrict__ density, int B, int Sq,
                               int Sk, int H, int KV, int n_tiles,
                               int seq_len, int window, int n_sinks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * Sk) return;
  const int b = idx / Sk, j = idx % Sk;
  float x = 0.0f;
  for (int h = 0; h < KV; ++h)
    for (int t = 0; t < n_tiles; ++t)
      x += part[(((size_t)b * KV + h) * n_tiles + t) * Sk + j];
  int n = 0;
  for (int i = 0; i < Sq; ++i)
    n += visible(j, q_pos[i], seq_len, window, n_sinks);
  density[idx] = x / (float)(H * max(n, 1));
}

template <bool SERVED, bool MASS>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<SERVED, MASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attn_kernel<SERVED, MASS>
      <<<B * a.KV * a.n_tiles, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Query tiles of the kernel for a group of G query heads: 64 / G queries
// each.  The wrapper sizes the (B, KV, n_tiles, Sk) scratch with it.
extern "C" int attn_density_tiles(int Sq, int G) {
  if (G <= 0 || G > kRows) return -1;
  const int bq = kRows / G;
  return (Sq + bq - 1) / bq;
}

// C interface (loaded with ctypes).  Returns the CUDA error of the
// launches (0 = launched), or -1 for shapes the kernel does not take
// (hd > 128, H not a multiple of KV, G = H / KV > 64).  `density` may be
// null: then no mass is summed and `part` is not touched.
extern "C" int attn_density(const void* q, const void* k, const void* v,
                            const void* q_pos, void* out, void* part,
                            void* density, int B, int Sq, int Sk, int H,
                            int KV, int hd, int seq_len, int window,
                            int n_sinks, float scale, int served,
                            void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      hd <= 0 || hd > kMaxHd || H / KV > kRows)
    return -1;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.seq_len = seq_len;
  a.window = window;
  a.n_sinks = n_sinks;
  a.bq = kRows / (H / KV);
  a.n_tiles = attn_density_tiles(Sq, H / KV);
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool want = density != nullptr;
  const size_t smem =
      sizeof(float) * ((size_t)2 * hd * kLd + (size_t)kKeys * hd +
                       (size_t)kRows * kLd + 3 * kRows) +
      sizeof(int) * (2 * kRows + 4);
  cudaError_t err;
  if (want) {
    err = cudaMemsetAsync(part, 0,
                          sizeof(float) * (size_t)B * KV * a.n_tiles * Sk,
                          st);
    if (err != cudaSuccess) return (int)err;
  }
  if (served && want)
    err = launch<true, true>(a, B, smem, st);
  else if (served)
    err = launch<true, false>(a, B, smem, st);
  else if (want)
    err = launch<false, true>(a, B, smem, st);
  else
    err = launch<false, false>(a, B, smem, st);
  if (err != cudaSuccess || !want) return (int)err;
  density_kernel<<<(B * Sk + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), a.q_pos, static_cast<float*>(density),
      B, Sq, Sk, H, KV, a.n_tiles, seq_len, window, n_sinks);
  return (int)cudaGetLastError();
}
