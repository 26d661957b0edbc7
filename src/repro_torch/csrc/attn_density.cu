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
// The function.  q (B,Sq,H,Dqk) bf16; k (B,Sk,KV,Dqk) bf16; v
// (B,Sk,KV,Dv) bf16; q_pos (Sq,) int32; out (B,Sq,H,Dv).  Dqk <= 256
// and Dv <= 256 (MLA's recompute: 128 + 64 and 128; the dense family:
// Dqk = Dv = hd; recurrentgemma's local MQA: 256 and 256).  Key j is visible to query i when j <= q_pos[i],
// j < seq_len and, with a window, j > q_pos[i] - window or j < n_sinks.
// Scores are fp32 dot products times 1/sqrt(Dqk); invisible keys take the finite
// NEG_INF = -0.7 FLT_MAX, so a query with no visible key is uniform over
// all Sk keys.  Query head h reads kv-head h / G, G = H / KV.  Two forms
// (template SERVED):
//   served — softmax p = exp(s - m) / l in fp32, p rounded to bf16
//            before PV (fp32 accumulation), out = bf16(sum); the mass
//            sums p over heads and queries (uniform rows included);
//   flash  — the Pallas kernel: out = bf16(sum_j exp(s_j - m) v_j /
//            max(l, 1e-30)); here PV takes exp(s_j - m) rounded to bf16
//            (the tensor cores' operand), which keeps out within two bf16
//            ulps of max|out| of the fp32-p plain version; the mass sums
//            p / max(l, 1e-30) in fp32 over visible (query, key) pairs.
// density (B,Sk) = mass / (H * max(1, visible queries of the key)).
// Row stats (attn_density_stats_kernel, the flash form without the
// density): each (query, head) row's max m and sum max(l, 1e-30) as a
// (2, B, KV, G, Sq) fp32 buffer — the layout of the reference's
// _flash_fwd_impl, whose m and l the training path's custom backward
// reads (src/repro/models/common.py flash_attention; here
// models/common.py flash_attention).  l is stored clamped, as the PV
// divides by it; the reference's backward reads max(l, 1e-30), the same
// value.  The stats kernel is the flash kernel's body with one more
// store after the slices' (m, l) are combined, compiled apart so the
// other instantiations keep their machine code.
//
// What runs here.  Every served form (serving's extend, its bit plans,
// recovery recompute, extend_nod), and the flash form at head dims other
// than Dqk = Dv = 64 or 128 (MLA's 192/128, recurrentgemma's 256, the
// tests' small dims).  The flash form at 64 and 128 (the prefill's,
// training's and the dry run's attention) runs csrc/attn_flash.cu, a
// wgmma + TMA forward with a key-major density pass; the wrapper picks
// by form and head dims alone (kernels/attn_density.py route()).
//
// Design.  Rows are (query, head) pairs flattened as row = qi * G + g, so
// one K/V tile serves a whole group and any G <= 64 works.  A block of 4
// warps takes 16 or 64 rows (the host plan attn_density_rows: 64 when
// that still gives one block per SM, else 16, so serving's extend — 64
// queries, G 1, 32 kv-heads — runs 4 tiles x 32 = 128 blocks, not 32).
// With 16 rows the 4 warps split every 64-key tile into four 16-key
// slices; with 64 rows each warp owns 16 rows and all 64 keys.  Keys go
// through shared memory as bf16 in double-buffered 64-key tiles filled
// with cp.async (16 B a thread; zero-filled past Sk and past the head
// dims: Dqk padded to HDQ = 64, 128, 192 or 256 (the QK k-steps), Dv to
// HDV = min(HDQ, 128) (the PV fragments); K rows HDQ wide, V rows HDV
// wide);
// Q is loaded once, into registers, through K's first stage.  A tile
// every row sees whole skips the per-key mask.  QK and PV run on the tensor
// cores, mma.sync.m16n8k16 bf16 -> fp32 with ldmatrix (.trans for V).
// The served form's bf16 p is exactly PV's A operand.  Passes:
//   served: (1) QK, online row max m and sum l; (2) QK again, p =
//           exp(s - m) / l, its column sums, PV;
//   flash:  (1) online softmax with PV; (2), only with the density, QK
//           again for p / l and its column sums.
// A warp's (m, l) and PV partials over its key slice are combined across
// the slices in a fixed order in shared memory.  Column sums come
// straight from the score fragments: a shuffle over the 8 lanes that
// hold a column's rows, then (64-row blocks) a fixed-order sum over the
// warps; one scratch row per query tile of a (B, KV, n_tiles, Sk) buffer
// (zeroed first).  A second launch, one block per (b, 32 keys), sums the
// scratch over tiles and kv-heads and counts each key's visible queries,
// 8 warps striding both, then adds the 8 partials in order.  No
// floating-point atomics: reruns are bit-identical, and so are the bit
// plans.  Key tiles that no row of the block can see (past the causal
// edge or seq_len, or wholly below every row's window and above the
// sinks) are skipped, unless a row of the block sees no key at all (then
// every tile counts, as its uniform p covers all Sk keys).
//
// Shared memory: 2 stages of 64 keys of K (HDQ + 8) and V (HDV + 8)
// bf16 and the reduction buffers — 71,440 B a 64-row block at 128/128
// (three blocks fit an SM), 87,824 B at MLA's 192/128 (two fit),
// 104,208 B at 256 (two fit).
//
// Head dim 256 (HDQ 256, Dv up to 256).  A block's PV accumulators stay
// at HDV = 128 columns: Q's fragments at 256 are 64 registers a thread
// and 128 columns of O another 64, so a 256-wide O would not fit beside
// them.  Instead a second grid axis takes Dv in 128-column halves: each
// block recomputes QK and the softmax of its rows (the same code on the
// same data, so both halves hold the same m, l and p), loads and
// multiplies only its half of V, and writes its 128 output columns;
// only half 0 sums the key mass into the scratch (half 1 skips the
// flash form's mass pass).  That doubles the QK work at 256 and nowhere
// else: the 64, 128 and 192/128 instantiations compile as before (the
// split is a compile-time branch on HDQ).  A simple design that is
// right first; wgmma tiles with the whole of O across a warpgroup are
// csrc/attn_flash.cu's, at 64 and 128, and later work at 192/128 and
// 256.
//
// Bound.  Bytes: q, the visible K/V rows and out once, about
// (Sq H Dqk + n_keys KV (Dqk + Dv) + Sq H Dv) * 2 bytes; operations:
// 2 (Dqk + Dv) per visible (row, key) pair (QK and PV multiply-adds) at
// the bf16 tensor-core rate — the served form and the density do 2 Dqk
// more per pair for the second QK.  At serving's extend both are about a microsecond: 128
// blocks of 4 warps each walk at most 4 key tiles twice, so the kernel is
// latency-bound (load, mma, shuffle chains) well above the bound.
//
// Numerics: expf (accurate, no --use_fast_math), IEEE division
// (-prec-div=true), round-to-nearest for every bf16 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;        // keys of a tile
constexpr int kMaxDqk = 256;
constexpr int kMaxDv = 256;
constexpr int kMaxGroup = 64;
constexpr int kWaveBlocks = 132;  // SMs of an H100 SXM
// the port's NEG_INF: -0.7 * float32 max computed in double, then cast
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* q_pos;
  __nv_bfloat16* out;
  float* part;  // (B, KV, n_tiles, Sk) per-tile key mass, or null
  int Sq, Sk, H, KV, G, dqk, dv, seq_len, window, n_sinks, n_tiles, vec;
  // seq_len as a device int32 (serving's extend, whose captured CUDA
  // graph replays with each call's value), or null: then seq_len
  const int* seq_len_p;
  float scale;
  // the stats kernel's (2, B, KV, G, Sq) row max m and row sum l (m at
  // 0, l at stats_l), or null
  float* stats;
  size_t stats_l;
};

// the seq_len a launch runs with: the device int32 at p, else v
__device__ __forceinline__ int read_seq_len(const int* p, int v) {
  return p != nullptr ? *p : v;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Q's rows share K's first stage: Q is in registers before any K tile
// is loaded (16 RW <= 2 kKeys rows of HDQ + 8)
template <int RW, int HDQ, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * kKeys) * (HDQ + 8 + HDV + 8) +
         sizeof(float) * (kWarps * kKeys + 16 * RW) +
         sizeof(int) * (2 * 16 * RW + 4);
}

// RW row groups of 16 rows per block, 4 / RW warps sharing each one;
// HDQ = Dqk padded to 64, 128, 192 or 256, HDV = Dv padded to min(HDQ,
// 128); at HDQ 256 blockIdx.y picks V's 128-column half.
// The flash form's 64-row variants at HDQ <= 128 are held to 168
// registers so that three blocks share an SM (measured faster at the
// Pallas setting); the served form's spill at that bound and gain
// nothing, and at HDQ 192 shared memory allows two blocks anyway.
template <int RW, int HDQ, int HDV, bool SERVED, bool MASS, bool STATS>
__device__ __forceinline__ void attn_density_tc(const Args a) {
  constexpr int KW = kWarps / RW;  // key slices of a tile
  constexpr int ROWS = 16 * RW;
  constexpr int WK = kKeys / KW;   // keys of a warp's slice
  constexpr int NT = WK / 8;       // score fragments (n = 8) of a warp
  constexpr int KS = HDQ / 16;     // QK k-steps
  constexpr int NO = HDV / 8;      // out fragments
  // bf16 row strides: ldmatrix clash-free
  constexpr int LDQ = HDQ + 8, LDV = HDV + 8;
  static_assert(16 * RW <= 2 * kKeys, "Q's rows fit K's stages");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kKeys][LDQ]
  __nv_bfloat16* Vs = Ks + 2 * kKeys * LDQ;                    // [2][kKeys][LDV]
  __nv_bfloat16* Qs = Ks;  // [ROWS][LDQ], K's first stage
  float* red = reinterpret_cast<float*>(Vs + 2 * kKeys * LDV);  // [4][kKeys]
  float* l_row = red + kWarps * kKeys;                    // [ROWS]
  int* qp_s = reinterpret_cast<int*>(l_row + ROWS);
  int* act_s = qp_s + ROWS;
  int* blk = act_s + ROWS;  // any row empty, key end, min qp, max qp
  float* obuf = reinterpret_cast<float*>(smem);  // [kWarps][16][HDV], at end

  const int Sk = a.Sk, dqk = a.dqk, dv = a.dv, G = a.G;
  const int seq_len = read_seq_len(a.seq_len_p, a.seq_len);
  const int tile = blockIdx.x % a.n_tiles;
  const int kvh = (blockIdx.x / a.n_tiles) % a.KV;
  const int b = blockIdx.x / (a.n_tiles * a.KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp / KW, ks = warp % KW;
  const int n_rows = a.Sq * G, row0 = tile * ROWS;
  // HDQ 256: this block's half of V (columns v0 .. v0 + dvh - 1) and of
  // out; half 0 alone sums the key mass
  constexpr bool VSPLIT = HDQ > 192;
  const int v0 = VSPLIT ? (int)blockIdx.y * HDV : 0;
  const int dvh = VSPLIT ? min(HDV, dv - v0) : dv;
  const bool mass = MASS && v0 == 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // ---- rows and Q ---------------------------------------------------- //
  if (tid < ROWS) {
    const int gr = row0 + tid, act = gr < n_rows;
    act_s[tid] = act;
    qp_s[tid] = act ? a.q_pos[gr / G] : 0;
  }
  for (int e = tid; e < ROWS * (HDQ / 8); e += kThreads) {
    const int r = e / (HDQ / 8), c = (e % (HDQ / 8)) * 8, gr = row0 + r;
    __nv_bfloat16* dst = Qs + r * LDQ + c;
    const size_t base =
        gr < n_rows
            ? (((size_t)b * a.Sq + gr / G) * a.H + kvh * G + gr % G) * dqk
            : 0;
    if (gr < n_rows && a.vec && c < dqk) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(a.q + base + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[i] = (gr < n_rows && c + i < dqk) ? a.q[base + c + i] : zero;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int empty = 0, kend = 0, qmin = 0x7fffffff, qmax = 0;
    for (int r = 0; r < ROWS; ++r) {
      if (!act_s[r]) continue;
      const int qp = qp_s[r];
      empty |= !sees_a_key(qp, seq_len, Sk, a.window, a.n_sinks);
      kend = max(kend, min(qp, min(seq_len, Sk) - 1) + 1);
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
    blk[0] = empty;
    blk[1] = empty ? Sk : kend;
    blk[2] = qmin;
    blk[3] = qmax;
  }
  __syncthreads();
  const int kend = blk[1], qmin = blk[2], qmax = blk[3];
  const bool all_tiles = blk[0] != 0;
  // a tile no row of the block can see: wholly below every row's window
  // and at or above the sinks (tiles past kend are not walked at all)
  auto skip = [&](int k0) {
    return !all_tiles && a.window > 0 && k0 >= a.n_sinks &&
           k0 + kKeys - 1 <= qmin - a.window;
  };
  // a tile every row of the block sees whole: no per-key mask
  auto full = [&](int k0) {
    const int k1 = k0 + kKeys - 1;
    return k1 < Sk && k1 < seq_len && k1 <= qmin &&
           (a.window <= 0 || k0 > qmax - a.window);
  };

  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int rl = rg * 16 + lane / 4;
  const int qp2[2] = {qp_s[rl], qp_s[rl + 8]};
  const bool act2[2] = {act_s[rl] != 0, act_s[rl + 8] != 0};
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], Qs + (rg * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
  __syncthreads();  // Q's rows are K's first stage

  // K (and V) tile k0 into stage st, zero past Sk and past each operand's
  // head dim; one pass over K's 16-byte columns that also moves V's (V's
  // rows are no wider: HDV <= HDQ); one cp.async group per call
  auto load_tile = [&](int k0, int st, bool with_v) {
    __nv_bfloat16* kd = Ks + st * kKeys * LDQ;
    __nv_bfloat16* vd = Vs + st * kKeys * LDV;
    for (int e = tid; e < kKeys * (HDQ / 8); e += kThreads) {
      const int j = e / (HDQ / 8), c = (e % (HDQ / 8)) * 8, key = k0 + j;
      const size_t row = key < Sk ? ((size_t)b * Sk + key) * a.KV + kvh : 0;
      const bool v_too = with_v && (HDV == HDQ || c < HDV);
      if (a.vec) {
        const bool ik = key < Sk && c < dqk, iv = key < Sk && c < dvh;
        cp_async16(kd + j * LDQ + c, a.k + (ik ? row * dqk + c : 0),
                   ik ? 16 : 0);
        if (v_too)
          cp_async16(vd + j * LDV + c, a.v + (iv ? row * dv + v0 + c : 0),
                     iv ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ik = key < Sk && c + i < dqk;
          const bool iv = key < Sk && c + i < dvh;
          kd[j * LDQ + c + i] = ik ? a.k[row * dqk + c + i] : zero;
          if (v_too)
            vd[j * LDV + c + i] = iv ? a.v[row * dv + v0 + c + i] : zero;
        }
      }
    }
    cp_async_commit();
  };
  // walk the tiles the block needs, the next one loading while this one
  // is used
  auto walk = [&](bool with_v, auto&& body) {
    int k0 = 0;
    while (k0 < kend && skip(k0)) k0 += kKeys;
    if (k0 < kend) load_tile(k0, 0, with_v);
    int st = 0;
    while (k0 < kend) {
      int kn = k0 + kKeys;
      while (kn < kend && skip(kn)) kn += kKeys;
      if (kn < kend)
        load_tile(kn, st ^ 1, with_v);
      else
        cp_async_commit();  // an empty group: wait_group 1 stays right
      cp_async_wait1();
      __syncthreads();
      body(st, k0);
      __syncthreads();
      k0 = kn;
      st ^= 1;
    }
  };
  // masked scores of this warp's key slice of tile k0: rows (rl, rl + 8)
  // in elements (0, 1) and (2, 3), keys past Sk at -inf
  auto scores = [&](int st, int k0, float (&s)[NT][4]) {
    const __nv_bfloat16* kt = Ks + (st * kKeys + ks * WK) * LDQ;
    const bool whole = full(k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS / 2; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (j * 8 + lane % 8) * LDQ + kk * 32 + (lane / 8) * 8);
        mma16816(s[j], qf[2 * kk], bk[0], bk[1]);
        mma16816(s[j], qf[2 * kk + 1], bk[2], bk[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + ks * WK + j * 8 + 2 * (lane % 4) + (e & 1);
        s[j][e] = whole       ? s[j][e] * a.scale
                  : key >= Sk ? __int_as_float(0xff800000)
                  : visible(key, qp2[e / 2], seq_len, a.window, a.n_sinks)
                      ? s[j][e] * a.scale
                      : kNegInf;
      }
    }
  };
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  // o += bf16(p) V over this warp's key slice
  auto pv = [&](int st, const float (&p)[NT][4]) {
    const __nv_bfloat16* vt = Vs + (st * kKeys + ks * WK) * LDV;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDV +
                          np * 16 + (lane / 16) * 8);
        mma16816(o[2 * np], pa, bv[0], bv[1]);
        mma16816(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  };
  // column sums of the active rows of p into this tile's scratch row
  auto colsum = [&](int k0, const float (&p)[NT][4]) {
    float cs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = (act2[0] ? p[j][c] : 0.0f) + (act2[1] ? p[j][2 + c] : 0.0f);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        cs[j][c] = x + __shfl_xor_sync(0xffffffffu, x, 16);
      }
    float* prow =
        a.part + (((size_t)b * a.KV + kvh) * a.n_tiles + tile) * Sk + k0;
    if (RW == 1) {
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = ks * WK + j * 8 + 2 * lane + c;
            if (k0 + key < Sk) prow[key] = cs[j][c];
          }
    } else {
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            red[warp * kKeys + j * 8 + 2 * lane + c] = cs[j][c];
      __syncthreads();
      if (tid < kKeys && k0 + tid < Sk) {
        float x = 0.0f;
        for (int w = 0; w < kWarps; ++w) x += red[w * kKeys + tid];
        prow[tid] = x;
      }
    }
  };

  // ---- pass 1: (m, l) of this warp's slices; flash: with PV --------- //
  float m_w[2] = {kNegInf, kNegInf}, l_w[2] = {0.0f, 0.0f};
  walk(!SERVED, [&](int st, int k0) {
    float s[NT][4];
    scores(st, k0, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      const float m_new = fmaxf(m_w[h], quad_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[j][2 * h + c] - m_new);
          if (!SERVED) s[j][2 * h + c] = p;
          sum += p;
        }
      const float alpha = expf(m_w[h] - m_new);
      l_w[h] = l_w[h] * alpha + quad_sum(sum);
      m_w[h] = m_new;
      if (!SERVED)
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * h] *= alpha;
          o[n][2 * h + 1] *= alpha;
        }
    }
    if (!SERVED) pv(st, s);
  });

  // ---- the row group's (m, l) over its slices, in slice order -------- //
  if (lane % 4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      red[(warp * 16 + lane / 4 + 8 * h) * 2] = m_w[h];
      red[(warp * 16 + lane / 4 + 8 * h) * 2 + 1] = l_w[h];
    }
  __syncthreads();
  float m_g[2], l_g[2], f_w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane / 4 + 8 * h;
    float m = kNegInf, l = 0.0f;
    for (int w = 0; w < KW; ++w)
      m = fmaxf(m, red[((rg * KW + w) * 16 + r) * 2]);
    for (int w = 0; w < KW; ++w) {
      const float* x = red + ((rg * KW + w) * 16 + r) * 2;
      l += x[1] * expf(x[0] - m);
    }
    m_g[h] = m;
    l_g[h] = fmaxf(l, 1e-30f);
    f_w[h] = expf(m_w[h] - m);  // this slice's share of the flash PV
  }
  if (ks == 0 && lane % 4 == 0) {
    l_row[rl] = l_g[0];
    l_row[rl + 8] = l_g[1];
    // the flash form's row stats, (B, KV, G, Sq): l as the PV divides by
    // it, max(l, 1e-30); at HDQ 256 both halves hold the same, half 0
    // writes
    if (STATS && v0 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + rl + 8 * h;
        if (!act2[h]) continue;
        const size_t i =
            (((size_t)b * a.KV + kvh) * G + gr % G) * a.Sq + gr / G;
        a.stats[i] = m_g[h];
        a.stats[a.stats_l + i] = l_g[h];
      }
  }
  __syncthreads();  // red is reused below

  // ---- pass 2: p (and its column sums); served: PV ------------------- //
  if (SERVED || mass)
    walk(SERVED, [&](int st, int k0) {
      float s[NT][4];
      scores(st, k0, s);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          s[j][e] = (SERVED || x != kNegInf)
                        ? expf(x - m_g[e / 2]) / l_g[e / 2]
                        : 0.0f;
        }
      if (mass) colsum(k0, s);
      if (SERVED) pv(st, s);
    });

  // ---- store: sum the slices' PV in order, normalise ----------------- //
  auto store = [&](int r, int d, float x) {
    const int gr = row0 + r;
    a.out[(((size_t)b * a.Sq + gr / G) * a.H + kvh * G + gr % G) * dv + v0 +
          d] = __float2bfloat16_rn(SERVED ? x : x / l_row[r]);
  };
  if (KW == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rl + 8 * (e / 2), d = n * 8 + 2 * (lane % 4) + (e & 1);
        if (act2[e / 2] && d < dvh) store(r, d, o[n][e]);
      }
  } else {
    // the tiles' buffers are free: the last walk ended with a barrier
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane / 4 + 8 * (e / 2);
        const int d = n * 8 + 2 * (lane % 4) + (e & 1);
        obuf[(warp * 16 + r) * HDV + d] =
            SERVED ? o[n][e] : o[n][e] * f_w[e / 2];
      }
    __syncthreads();
    for (int e = tid; e < ROWS * dvh; e += kThreads) {
      const int r = e / dvh, d = e % dvh;
      if (!act_s[r]) continue;
      const int g0 = (r / 16) * KW;
      float x = 0.0f;
      for (int w = 0; w < KW; ++w) x += obuf[((g0 + w) * 16 + r % 16) * HDV + d];
      store(r, d, x);
    }
  }
}

template <int RW, int HDQ, int HDV, bool SERVED, bool MASS>
__global__ void __launch_bounds__(kThreads,
                                  RW == 4 && !SERVED && HDQ <= 128 ? 3 : 1)
    attn_density_tc_kernel(const Args a) {
  attn_density_tc<RW, HDQ, HDV, SERVED, MASS, false>(a);
}

// the flash form without the density that also writes each row's (m, l):
// the forward of models/common.py flash_attention, whose backward reads
// them (the reference's _flash_vjp_fwd saves the same); a kernel of its
// own, so that the other instantiations keep their machine code
template <int RW, int HDQ, int HDV>
__global__ void __launch_bounds__(kThreads, RW == 4 && HDQ <= 128 ? 3 : 1)
    attn_density_stats_kernel(const Args a) {
  attn_density_tc<RW, HDQ, HDV, false, false, true>(a);
}

// density[b, j] = the scratch summed over kv-heads and query tiles, over
// H * max(1, number of queries that see key j).  One block per (32 keys,
// b); warp w takes every 8th scratch row and query, then warp 0 adds the
// 8 partials in order.
__global__ void __launch_bounds__(256)
    attn_density_reduce_kernel(const float* __restrict__ part,
                               const int* __restrict__ q_pos,
                               float* __restrict__ density, int Sq, int Sk,
                               int H, int n_rows,
                               const int* __restrict__ seq_len_p,
                               int seq_len_v, int window, int n_sinks) {
  __shared__ float xs[8][32];
  const int seq_len = read_seq_len(seq_len_p, seq_len_v);
  __shared__ int ns[8][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, b = blockIdx.y;
  const int j = blockIdx.x * 32 + lane;
  float x = 0.0f;
  int n = 0;
  if (j < Sk) {
    for (int t = w; t < n_rows; t += 8)
      x += part[((size_t)b * n_rows + t) * Sk + j];
    for (int i = w; i < Sq; i += 8)
      n += visible(j, q_pos[i], seq_len, window, n_sinks);
  }
  xs[w][lane] = x;
  ns[w][lane] = n;
  __syncthreads();
  if (w == 0 && j < Sk) {
    float s = 0.0f;
    int c = 0;
    for (int i = 0; i < 8; ++i) {
      s += xs[i][lane];
      c += ns[i][lane];
    }
    density[(size_t)b * Sk + j] = s / (float)(H * max(c, 1));
  }
}

template <int RW, int HDQ, int HDV>
cudaError_t launch(void (*kern)(const Args), const Args& a, int B,
                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes<RW, HDQ, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // HDQ 256: one block a 128-column half of V (a Dv <= 128 has one)
  const int halves = HDQ > 192 ? (a.dv + HDV - 1) / HDV : 1;
  kern<<<dim3(B * a.KV * a.n_tiles, halves), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int RW, int HDQ, int HDV>
cudaError_t launch_form(const Args& a, int B, bool served, bool mass,
                        cudaStream_t st) {
  if (a.stats)
    return launch<RW, HDQ, HDV>(attn_density_stats_kernel<RW, HDQ, HDV>, a,
                                B, st);
  if (served && mass)
    return launch<RW, HDQ, HDV>(
        attn_density_tc_kernel<RW, HDQ, HDV, true, true>, a, B, st);
  if (served)
    return launch<RW, HDQ, HDV>(
        attn_density_tc_kernel<RW, HDQ, HDV, true, false>, a, B, st);
  if (mass)
    return launch<RW, HDQ, HDV>(
        attn_density_tc_kernel<RW, HDQ, HDV, false, true>, a, B, st);
  return launch<RW, HDQ, HDV>(
      attn_density_tc_kernel<RW, HDQ, HDV, false, false>, a, B, st);
}

template <int RW>
cudaError_t launch_dims(const Args& a, int B, int hdq, bool served,
                        bool mass, cudaStream_t st) {
  if (hdq == 64) return launch_form<RW, 64, 64>(a, B, served, mass, st);
  if (hdq == 128) return launch_form<RW, 128, 128>(a, B, served, mass, st);
  if (hdq == 192) return launch_form<RW, 192, 128>(a, B, served, mass, st);
  return launch_form<RW, 256, 128>(a, B, served, mass, st);
}

// the padded head dims: HDQ = max(Dqk, Dv) rounded up to 64, 128, 192
// or 256 (256 for any Dv > 128: only there does V come in halves), HDV =
// min(HDQ, 128); 0 for dims the kernel does not take
int padded_dqk(int dqk, int dv) {
  if (dqk <= 0 || dv <= 0 || dqk > kMaxDqk || dv > kMaxDv) return 0;
  const int w = max(dqk, dv);
  return w <= 64 ? 64 : w <= 128 ? 128 : w <= 192 && dv <= 128 ? 192 : 256;
}

}  // namespace

// The tile plan: rows of a block, 64 when B * KV * ceil(Sq G / 64) blocks
// still fill the card's SMs once, else 16.  The wrapper sizes the
// (B, KV, n_tiles, Sk) scratch with it (kernels/attn_density.py plan()
// is the same rule); -1 for shapes the kernel does not take.
extern "C" int attn_density_rows(int B, int Sq, int H, int KV) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV ||
      H / KV > kMaxGroup)
    return -1;
  const long long rows = (long long)Sq * (H / KV);
  return (long long)B * KV * ((rows + 63) / 64) >= kWaveBlocks ? 64 : 16;
}

// C interface (loaded with ctypes).  Returns the CUDA error of the
// launches (0 = launched), or -1 for shapes the kernel does not take
// (Dqk > 256, Dv > 256, H not a multiple of KV, G = H / KV > 64) and for
// stats asked of the served form or beside the density.  `density` may
// be null: then no mass is summed and `part` is not touched.  `stats`
// may be null; else it is a (2, B, KV, G, Sq) fp32 buffer that the flash
// form without the density fills with each row's max m and sum
// max(l, 1e-30) (attn_density_stats_kernel).  `seq_len_dev` may be
// null; else it points at a device int32 that both launches read as
// seq_len in place of `seq_len` (a captured CUDA graph keeps the
// pointer, and each replay reads the value its call staged there).
extern "C" int attn_density(const void* q, const void* k, const void* v,
                            const void* q_pos, void* out, void* part,
                            void* density, void* stats,
                            const void* seq_len_dev, int B, int Sq,
                            int Sk, int H, int KV, int dqk, int dv,
                            int seq_len, int window, int n_sinks,
                            float scale, int served, void* stream) {
  const int rows = attn_density_rows(B, Sq, H, KV);
  const int hdq = padded_dqk(dqk, dv);
  if (rows < 0 || Sk <= 0 || hdq == 0) return -1;
  if (stats != nullptr && (served != 0 || density != nullptr)) return -1;
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
  a.G = H / KV;
  a.dqk = dqk;
  a.dv = dv;
  a.seq_len = seq_len;
  a.seq_len_p = static_cast<const int*>(seq_len_dev);
  a.window = window;
  a.n_sinks = n_sinks;
  a.n_tiles = (Sq * a.G + rows - 1) / rows;
  a.vec = dqk % 8 == 0 && dv % 8 == 0;
  a.scale = scale;
  a.stats = static_cast<float*>(stats);
  a.stats_l = (size_t)B * H * Sq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool want = density != nullptr;
  cudaError_t err;
  if (want) {
    err = cudaMemsetAsync(part, 0,
                          sizeof(float) * (size_t)B * KV * a.n_tiles * Sk,
                          st);
    if (err != cudaSuccess) return (int)err;
  }
  const bool sv = served != 0;
  err = rows == 64 ? launch_dims<4>(a, B, hdq, sv, want, st)
                   : launch_dims<1>(a, B, hdq, sv, want, st);
  if (err != cudaSuccess || !want) return (int)err;
  attn_density_reduce_kernel<<<dim3((Sk + 31) / 32, B), 256, 0, st>>>(
      static_cast<const float*>(part), a.q_pos, static_cast<float*>(density),
      Sq, Sk, H, KV * a.n_tiles, a.seq_len_p, seq_len, window, n_sinks);
  return (int)cudaGetLastError();
}
