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
// Design.  One thread per channel column f: neighbouring threads read
// neighbouring addresses of every row, so each row load of a warp is
// one coalesced transaction.  A thread walks its column twice: once for
// max|x| (the scale), once to round and pack `per = 8/bits` tokens into
// each byte.  The TPU kernel's 128-lane padding has no counterpart:
// the last block masks its ragged edge.
//
// Bound.  Memory: at the serving shape (T=16, F=32*32*128=131072,
// bf16) quantize reads 4 MiB and writes T*bits/8*F + 4F bytes (1.5 MiB
// at 4 bits), about 1.7 us at 3.35 TB/s; dequantize is the mirror
// image.  At this size the launch cost (several microseconds from the
// host) is larger than the bound; fusing the per-leaf launches of a
// chunk is work for a later change.
//
// Numerics that must match the reference bit for bit:
//   * the scale is max|x| times the correctly rounded fp32 reciprocal of
//     qmax: the reference's codec runs under jax.jit, where XLA rewrites
//     its division by the constant qmax into that product,
//   * the codes divide by the scale in IEEE division (__fdiv_rn; the
//     build keeps -prec-div=true and no --use_fast_math),
//   * rintf (round half to even), not roundf,
//   * packed bytes are read as UNSIGNED before unpacking,
//   * the bf16 output is rounded with __float2bfloat16_rn.
// max|x| ignores NaN here where jnp.max propagates it; chunk blocks
// hold finite values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Tin, int BITS>
__global__ void quant_kernel(const Tin* __restrict__ x,
                             int8_t* __restrict__ packed,
                             float* __restrict__ scale, int T, int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float qm = (float)((1 << (BITS - 1)) - 1);
  float mx = 0.0f;
  for (int t = 0; t < T; ++t)
    mx = fmaxf(mx, fabsf(load_f32(x + (size_t)t * F + f)));
  const float s = fmaxf(__fmul_rn(mx, __frcp_rn(qm)), 1e-8f);
  scale[f] = s;
  constexpr int per = 8 / BITS;
  constexpr unsigned mask = (1u << BITS) - 1u;
  for (int r = 0; r < T / per; ++r) {
    unsigned acc = 0;
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const float v = load_f32(x + (size_t)(r * per + j) * F + f);
      const int c = (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -qm), qm);
      acc |= ((unsigned)c & mask) << (BITS * j);
    }
    packed[(size_t)r * F + f] = (int8_t)(uint8_t)acc;
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

template <typename Tin>
void launch_quant(const void* x, void* packed, void* scale, int T, int F,
                  int bits, cudaStream_t st) {
  const dim3 grid((F + kThreads - 1) / kThreads), block(kThreads);
  const Tin* xp = static_cast<const Tin*>(x);
  int8_t* pp = static_cast<int8_t*>(packed);
  float* sp = static_cast<float*>(scale);
  if (bits == 8)
    quant_kernel<Tin, 8><<<grid, block, 0, st>>>(xp, pp, sp, T, F);
  else if (bits == 4)
    quant_kernel<Tin, 4><<<grid, block, 0, st>>>(xp, pp, sp, T, F);
  else
    quant_kernel<Tin, 2><<<grid, block, 0, st>>>(xp, pp, sp, T, F);
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
extern "C" int chunk_quantize(const void* x, int x_dtype, void* packed,
                              void* scale, int T, int F, int bits,
                              void* stream) {
  if (bad_args(T, F, bits) || (x_dtype != 0 && x_dtype != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    launch_quant<float>(x, packed, scale, T, F, bits, st);
  else
    launch_quant<__nv_bfloat16>(x, packed, scale, T, F, bits, st);
  return (int)cudaGetLastError();
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
