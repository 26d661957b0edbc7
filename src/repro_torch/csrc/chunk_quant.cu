// Chunk codec kernels for Hopper (sm_90a): symmetric per-channel
// quantization of a (T, F) chunk block and its inverse.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/chunk_quant.py  quantize   (_quant_kernel)
//   src/repro/kernels/chunk_quant.py  dequantize (_dequant_kernel)
// and computes exactly what they compute (their oracle is
// kernels/ref.py; the plain PyTorch versions of these kernels are
// src/repro_torch/kernels/ref.py, held against them bit for bit).
//
// Design of quantize: one launch for up to kMaxLeaves leaves of one
// chunk (the k and v blocks of a chunk switched out: one T, one bit
// width, per-leaf pointers and F, passed by value), the grid cut into
// each leaf's blocks.  A thread takes 4 adjacent columns (one 8 B load
// a row of bf16, 16 B of fp32) of RT = T / R rows, R threads sharing a
// column group (rows_split: RT <= 4 for every T <= 32, per = 8 / bits
// dividing RT so that a thread holds whole packed bytes).  The RT x 4
// values stay in registers: the block is read once, max|x| comes from
// them, the R partial maxima combine by shuffles in a fixed order, and
// the codes pack from the same registers (code_of: the correctly
// rounded quotient from the column's reciprocal by two FMA correction
// steps, then a rounding add); each packed row's 4 bytes go out in one
// 4 B store and the scales as one float4.  T > 32 takes a second pass
// over device memory.  The R threads of a column group sit 32 / R lanes
// apart, so a warp's loads of one row index cover 32 / R column groups,
// contiguous bytes of each of R rows.  At the serving shape (16,
// 131072) bf16, R = 4 and RT = 4: 131,072 threads in 1,024 blocks of
// 128, four loads in flight per thread.  Leaves whose F is not a
// multiple of 4, or whose pointers are not 16 B aligned, load and store
// element by element; the last column group masks its ragged edge.
//
// Design of dequantize: one thread per channel column f, neighbouring
// threads on neighbouring addresses of every row.
//
// Bound.  Memory: at the serving shape (T=16, F=32*32*128=131072,
// bf16) quantize reads 4 MiB and writes T*bits/8*F + 4F bytes (1.5 MiB
// at 4 bits), about 1.7 us at 3.35 TB/s a leaf; dequantize is the
// mirror image.  The host's cost of a launch is larger than that, so a
// chunk's leaves share one.
//
// Numerics that must match the reference bit for bit:
//   * the scale is max|x| times the correctly rounded fp32 reciprocal of
//     qmax: the reference's codec runs under jax.jit, where XLA rewrites
//     its division by the constant qmax into that product,
//   * the codes round the correctly rounded quotient x / scale (IEEE
//     division; quantize reaches it from the reciprocal by two FMA
//     correction steps: code_of),
//   * round half to even (rintf, or the 1.5 * 2^23 add), not roundf,
//   * packed bytes are read as UNSIGNED before unpacking,
//   * the bf16 output is rounded with __float2bfloat16_rn.
// max|x| ignores NaN here where jnp.max propagates it; chunk blocks
// hold finite values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // dequantize
constexpr int kQThreads = 128;    // quantize
constexpr int kMaxLeaves = 8;
constexpr int kHold = 4;          // rows a quantize thread holds

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the leaves of one quantize launch; leaf i owns blocks
// [block0[i], block0[i + 1])
struct Leaves {
  const void* x[kMaxLeaves];
  int8_t* packed[kMaxLeaves];
  float* scale[kMaxLeaves];
  int F[kMaxLeaves];
  int vec[kMaxLeaves];  // vector loads and stores
  int block0[kMaxLeaves + 1];
  int n, T, R;
};

constexpr int kCols = 4;  // columns a quantize thread takes

// row t's values at columns [f0, f0 + 4) as fp32 (one 8 B load of bf16
// or 16 B of fp32), zeros past F
template <typename Tin>
__device__ __forceinline__ void load_cols(const Tin* __restrict__ x, int t,
                                          int F, int f0, bool vec,
                                          float (&v)[kCols]) {
  const Tin* p = x + (size_t)t * F + f0;
  if (vec) {
    if constexpr (sizeof(Tin) == 2) {  // bf16: the high 16 bits of an fp32
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(w.x << 16);
      v[1] = __uint_as_float(w.x & 0xffff0000u);
      v[2] = __uint_as_float(w.y << 16);
      v[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      const float4 w = *reinterpret_cast<const float4*>(p);
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      v[i] = f0 + i < F ? load_f32(p + i) : 0.0f;
  }
}

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

// The code of v at scale s: the low BITS bits of rint(q), q = v / s
// correctly rounded (what IEEE division gives), without a division.
// With rs = rcp_rn(sd) normal, sd = s e (e = 1; at 2 bits 2^-64 for s
// >= 2^126, so that v e / sd = v / s exactly: at 8 and 4 bits s <=
// FLT_MAX / qmax < 2^126), q0 = v e rs is within two ulps of the
// quotient; one FMA correction step, q + (v e - sd q) rs, makes it
// faithful, and a second gives the correctly rounded quotient
// (Markstein: the remainder of a faithful q is exact in an FMA, and rs
// is the correctly rounded reciprocal).  Values whose scaled value or
// remainder underflows have |v / s| < 2^-70: code 0 either way.  q +
// 1.5 * 2^23 rounds q half to even into the sum's low bits, which hold
// the code's two's complement (|q| < 2^22).  The reference's clip to
// [-qm, qm] never binds: |q| <= qm (1 + 2^-22) rounds to at most qm.
// Seven full-rate operations a value: no division, and no quarter-rate
// rint or float-to-int conversion.
template <int BITS>
__device__ __forceinline__ unsigned code_of(float v, float e, float sd,
                                            float rs) {
  const float ve = BITS == 2 ? __fmul_rn(v, e) : v;
  float q = __fmul_rn(ve, rs);
  q = __fmaf_rn(__fmaf_rn(-q, sd, ve), rs, q);
  q = __fmaf_rn(__fmaf_rn(-q, sd, ve), rs, q);
  return (unsigned)__float_as_int(__fadd_rn(q, kMagic)) &
         ((1u << BITS) - 1u);
}

// one packed row's bytes of columns [f0, f0 + 4), byte c of w
__device__ __forceinline__ void store_packed(int8_t* __restrict__ p, int row,
                                             int F, int f0, bool vec,
                                             uint32_t w) {
  int8_t* d = p + (size_t)row * F + f0;
  if (vec) {
    *reinterpret_cast<uint32_t*>(d) = w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (f0 + c < F) d[c] = (int8_t)((w >> (8 * c)) & 0xffu);
  }
}

// one packed row of rows vals[0 .. per) (token r*per + j in bit group j)
template <int BITS>
__device__ __forceinline__ uint32_t pack_row(const float (*vals)[kCols],
                                             const float (&e)[kCols],
                                             const float (&sd)[kCols],
                                             const float (&rs)[kCols]) {
  constexpr int per = 8 / BITS;
  uint32_t w = 0u;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    unsigned byte = 0u;
#pragma unroll
    for (int j = 0; j < per; ++j)
      byte |= code_of<BITS>(vals[j][c], e[c], sd[c], rs[c]) << (BITS * j);
    w |= byte << (8 * c);
  }
  return w;
}

template <typename Tin, int BITS>
__global__ void __launch_bounds__(kQThreads)
    quant_leaves_kernel(const Leaves a) {
  constexpr int per = 8 / BITS;
  // the correctly rounded fp32 1 / qmax, as the reference's jitted codec
  constexpr float kRcpQm = 1.0f / (float)((1 << (BITS - 1)) - 1);
  int leaf = 0;
  while (leaf + 1 < a.n && (int)blockIdx.x >= a.block0[leaf + 1]) ++leaf;
  const Tin* x = static_cast<const Tin*>(a.x[leaf]);
  const int F = a.F[leaf], R = a.R, RT = a.T / R;
  const bool vec = a.vec[leaf] != 0;
  const int lane = threadIdx.x % 32, gpw = 32 / R;  // column groups a warp
  const int warp = ((int)blockIdx.x - a.block0[leaf]) * (kQThreads / 32) +
                   threadIdx.x / 32;
  const int t0 = (lane / gpw) * RT;                  // this thread's rows
  const int f0 = (warp * gpw + lane % gpw) * kCols;  // and columns
  const bool live = f0 < F;
  const bool hold = RT <= kHold;                     // one read of x

  float xv[kHold][kCols];
  float mx[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) mx[c] = 0.0f;
  if (hold) {
#pragma unroll
    for (int i = 0; i < kHold; ++i)
      if (i < RT && live) load_cols<Tin>(x, t0 + i, F, f0, vec, xv[i]);
#pragma unroll
    for (int i = 0; i < kHold; ++i)
      if (i < RT && live)
#pragma unroll
        for (int c = 0; c < kCols; ++c) mx[c] = fmaxf(mx[c], fabsf(xv[i][c]));
  } else {
    for (int i = 0; i < RT && live; ++i) {
      float v[kCols];
      load_cols<Tin>(x, t0 + i, F, f0, vec, v);
#pragma unroll
      for (int c = 0; c < kCols; ++c) mx[c] = fmaxf(mx[c], fabsf(v[c]));
    }
  }
  // the R threads of a column group: lanes gpw apart, in a fixed order
  for (int o = gpw; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], o));
  if (!live) return;
  float s[kCols], e[kCols], sd[kCols], rs[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    s[c] = fmaxf(__fmul_rn(mx[c], kRcpQm), 1e-8f);
    e[c] = BITS == 2 && s[c] >= 0x1p126f ? 0x1p-64f : 1.0f;  // rs normal
    sd[c] = __fmul_rn(s[c], e[c]);
    rs[c] = __frcp_rn(sd[c]);
  }
  if (t0 == 0) {
    float* d = a.scale[leaf] + f0;
    if (vec) {
      *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (f0 + c < F) d[c] = s[c];
    }
  }
  int8_t* packed = a.packed[leaf];
  if (hold) {
#pragma unroll
    for (int r = 0; r < kHold / per; ++r)
      if (r * per < RT)
        store_packed(packed, t0 / per + r, F, f0, vec,
                     pack_row<BITS>(xv + r * per, e, sd, rs));
  } else {  // T > 32: a second read of this thread's rows
    for (int r = 0; r < RT / per; ++r) {
      float v[per][kCols];
#pragma unroll
      for (int j = 0; j < per; ++j)
        load_cols<Tin>(x, t0 + r * per + j, F, f0, vec, v[j]);
      store_packed(packed, t0 / per + r, F, f0, vec,
                   pack_row<BITS>(v, e, sd, rs));
    }
  }
}

template <typename Tout, int BITS>
__global__ void dequant_kernel(const int8_t* __restrict__ packed,
                               const float* __restrict__ scale,
                               Tout* __restrict__ out, int T, int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float s = scale[f];
  constexpr int per = 8 / BITS;
  constexpr int mask = (1 << BITS) - 1;
  constexpr int half = 1 << (BITS - 1);
  for (int r = 0; r < T / per; ++r) {
    const int u = (int)(uint8_t)packed[(size_t)r * F + f];
#pragma unroll
    for (int j = 0; j < per; ++j) {
      int c = (u >> (BITS * j)) & mask;
      if (BITS < 8 && c >= half) c -= (1 << BITS);
      if (BITS == 8) c = (int)(int8_t)(uint8_t)u;
      store_f32(out + (size_t)(r * per + j) * F + f, (float)c * s);
    }
  }
}

// R: threads sharing a column group's T rows, each with RT = T / R rows
// of whole packed bytes (per divides RT): the fewest (1, 2, 4, 8) that
// leave RT <= kHold rows to hold in registers (every T <= 32), else the
// most that divide T so (a second pass over device memory)
int rows_split(int T, int bits) {
  const int per = 8 / bits;
  auto fits = [&](int R) { return T % R == 0 && (T / R) % per == 0; };
  for (int R = 1; R <= 8; R <<= 1)
    if (fits(R) && T / R <= kHold) return R;
  for (int R = 8; R > 1; R >>= 1)
    if (fits(R)) return R;
  return 1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Tin>
int launch_quant(const void* const* x, void* const* packed,
                 void* const* scale, const int* F, int n, int T, int bits,
                 cudaStream_t st) {
  constexpr int V = kCols;
  Leaves a;
  a.n = n;
  a.T = T;
  a.R = rows_split(T, bits);
  const int groups_per_block = kQThreads / a.R;
  a.block0[0] = 0;
  for (int i = 0; i < n; ++i) {
    a.x[i] = x[i];
    a.packed[i] = static_cast<int8_t*>(packed[i]);
    a.scale[i] = static_cast<float*>(scale[i]);
    a.F[i] = F[i];
    a.vec[i] = F[i] % V == 0 && aligned16(x[i]) && aligned16(packed[i]) &&
               aligned16(scale[i]);
    const int groups = (F[i] + V - 1) / V;
    a.block0[i + 1] =
        a.block0[i] + (groups + groups_per_block - 1) / groups_per_block;
  }
  const dim3 grid(a.block0[n]), block(kQThreads);
  if (bits == 8)
    quant_leaves_kernel<Tin, 8><<<grid, block, 0, st>>>(a);
  else if (bits == 4)
    quant_leaves_kernel<Tin, 4><<<grid, block, 0, st>>>(a);
  else
    quant_leaves_kernel<Tin, 2><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename Tout>
void launch_dequant(const void* packed, const void* scale, void* out, int T,
                    int F, int bits, cudaStream_t st) {
  const dim3 grid((F + kThreads - 1) / kThreads), block(kThreads);
  const int8_t* pp = static_cast<const int8_t*>(packed);
  const float* sp = static_cast<const float*>(scale);
  Tout* op = static_cast<Tout*>(out);
  if (bits == 8)
    dequant_kernel<Tout, 8><<<grid, block, 0, st>>>(pp, sp, op, T, F);
  else if (bits == 4)
    dequant_kernel<Tout, 4><<<grid, block, 0, st>>>(pp, sp, op, T, F);
  else
    dequant_kernel<Tout, 2><<<grid, block, 0, st>>>(pp, sp, op, T, F);
}

bool bad_args(int T, int F, int bits) {
  return T <= 0 || F <= 0 || (bits != 8 && bits != 4 && bits != 2) ||
         T % (8 / bits) != 0;
}

}  // namespace

// C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch (0 = launched), or -1 for arguments the kernel does
// not take.  dtype codes: 0 = float32, 1 = bfloat16.

// n (1 to 8) leaves (T, F[i]) of one dtype -> packed[i] (T*bits/8, F[i])
// int8 and scale[i] (F[i],) fp32, in one launch.  The pointer and F
// arrays are host memory, read before the call returns.
extern "C" int chunk_quantize_leaves(const void* const* x, int x_dtype,
                                     void* const* packed, void* const* scale,
                                     const int* F, int n, int T, int bits,
                                     void* stream) {
  if (n <= 0 || n > kMaxLeaves || (x_dtype != 0 && x_dtype != 1)) return -1;
  for (int i = 0; i < n; ++i)
    if (bad_args(T, F[i], bits)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? launch_quant<float>(x, packed, scale, F, n, T, bits, st)
             : launch_quant<__nv_bfloat16>(x, packed, scale, F, n, T, bits,
                                           st);
}

extern "C" int chunk_dequantize(const void* packed, const void* scale,
                                void* out, int out_dtype, int T, int F,
                                int bits, void* stream) {
  if (bad_args(T, F, bits) || (out_dtype != 0 && out_dtype != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    launch_dequant<float>(packed, scale, out, T, F, bits, st);
  else
    launch_dequant<__nv_bfloat16>(packed, scale, out, T, F, bits, st);
  return (int)cudaGetLastError();
}
