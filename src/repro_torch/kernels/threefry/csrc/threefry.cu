// Threefry-2x32 draws on the card: uniform, Bernoulli (0/1) and normal fp32
// values under a batch of keys, bit for bit those of jax.random in its
// partitionable mode (the reference's jax 0.9.0 default) and of the plain
// version in ../ref.py.
//
// It replaces no Pallas kernel. The reference draws its Hadamard signs, its
// packet masks, its stochastic-rounding noise and its initial weights with
// jax.random, which XLA compiles into the step; on the card the port needs the
// same bits, and plain int64 threefry in PyTorch would be ~160 elementwise
// launches and a temporary of 8 bytes a value for every draw (THC's shared
// noise alone is 152 M values).
//
// Value i of row k is threefry2x32(key_k, (hi32(i), lo32(i))), 20 rounds with
// rotations by __funnelshift_l and 5 key injections, then x0 ^ x1: about 68
// 32-bit integer operations a value. What bounds it on an H100: those integer
// operations, against 4 bytes written a value. Integer adds, shifts and logic
// issue on the INT32 lanes and, as IMAD, on the FP32 pipe: up to 128 a clock
// an SM, ~33.5 T/s; 68 ops over 4 B is 17 ops a byte, above the ~10 a byte
// where that rate meets 3.35 TB/s.
//
// Design. One thread computes 4 consecutive values and writes them with one
// 16-byte store where the row allows it (n % 4 == 0); the keys travel in the
// kernel's parameter space (at most kMaxKeys), so a draw needs no copy to the
// card and the host never waits on it. Every floating-point step is written
// out with its rounding (__fmul_rn, __fadd_rn, __fmaf_rn, __fdiv_rn,
// __fsqrt_rn) in the order of the plain version, which evaluates XLA's CPU
// formulas (the uniform's scale and the polynomials as fused multiply-adds,
// XLA's own log and log1p), so the two give the same bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxKeys = 256;
constexpr int kThreads = 256;

struct Keys {
  unsigned k[2 * kMaxKeys];
};

__device__ __forceinline__ void threefry(unsigned k0, unsigned k1,
                                         unsigned& x0, unsigned& x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r)                      \
  x0 += x1;                              \
  x1 = __funnelshift_l(x1, x1, r);       \
  x1 ^= x0;
#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_GROUP_A x0 += k1; x1 += k2 + 1u;
  TF_GROUP_B x0 += k2; x1 += k0 + 2u;
  TF_GROUP_A x0 += k0; x1 += k1 + 3u;
  TF_GROUP_B x0 += k1; x1 += k2 + 4u;
  TF_GROUP_A x0 += k2; x1 += k0 + 5u;
#undef TF_GROUP_B
#undef TF_GROUP_A
#undef TF_ROUND
}

// The fp32 constants, written as the plain version rounds them (hex floats)
__constant__ float kLogP[9] = {0x1.2043760000000p-4f, -0x1.d7a3700000000p-4f, 0x1.de4a340000000p-4f, -0x1.fcba9e0000000p-4f, 0x1.23d37e0000000p-3f, -0x1.555ca00000000p-3f, 0x1.999d580000000p-3f, -0x1.fffff80000000p-3f, 0x1.5555540000000p-2f};
__constant__ float kLog1pNum[7] = {0x1.7bc0960000000p-15f, 0x1.fe818a0000000p-2f, 0x1.a509f40000000p+2f, 0x1.de97380000000p+4f, 0x1.e798ec0000000p+5f, 0x1.c8e75a0000000p+5f, 0x1.40a2020000000p+4f};
__constant__ float kLog1pDen[7] = {0x1.0000000000000p+0f, 0x1.e2035a0000000p+3f, 0x1.4c30b60000000p+6f, 0x1.bb865a0000000p+7f, 0x1.3519460000000p+8f, 0x1.b0db140000000p+7f, 0x1.e0f3040000000p+5f};
__constant__ float kErfInvLt5[9] = {0x1.e2cb100000000p-26f, 0x1.70966c0000000p-22f, -0x1.d8e6ae0000000p-19f, -0x1.26b5820000000p-18f, 0x1.ca65b60000000p-13f, -0x1.48a8100000000p-10f, -0x1.11c9de0000000p-8f, 0x1.f91ec60000000p-3f, 0x1.805c5e0000000p+0f};
__constant__ float kErfInvGe5[9] = {-0x1.a3e1360000000p-13f, 0x1.a76ad60000000p-14f, 0x1.61b8e40000000p-10f, -0x1.e17bce0000000p-9f, 0x1.7824f60000000p-8f, -0x1.f38bae0000000p-8f, 0x1.354afc0000000p-7f, 0x1.006db60000000p+0f, 0x1.6a9efc0000000p+1f};
constexpr float kLogQ1 = -0x1.bd01060000000p-13f, kLogQ2 = 0x1.6300000000000p-1f;
constexpr float kSqrtHalf = 0x1.6a09e60000000p-1f, kLog1pSmall = 0x1.a8279a0000000p-2f;
constexpr float kMinNormal = 0x1.0000000000000p-126f, kSqrt2 = 0x1.6a09e60000000p+0f;

// XLA's fp32 log on the CPU (exponent split, Cephes polynomial), for v > 0
__device__ __forceinline__ float log_xla(float v) {
  const int bits = __float_as_int(fmaxf(v, kMinNormal));
  const float frac = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool small = frac < kSqrtHalf;
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 0x7F), 1.0f);
  float x = __fadd_rn(__fsub_rn(frac, 1.0f), small ? frac : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x), x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(x, kLogP[0], kLogP[1]);
  float y1 = __fmaf_rn(x, kLogP[3], kLogP[4]);
  float y2 = __fmaf_rn(x, kLogP[6], kLogP[7]);
  y = __fmaf_rn(y, x, kLogP[2]);
  y1 = __fmaf_rn(y1, x, kLogP[5]);
  y2 = __fmaf_rn(y2, x, kLogP[8]);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(__fmaf_rn(y, x3, y2), x3, __fmul_rn(kLogQ1, e));
  x = __fsub_rn(x, __fmul_rn(0.5f, x2));
  x = __fadd_rn(x, y);
  return __fadd_rn(x, __fmul_rn(kLogQ2, e));
}

// XLA's fp32 log1p: a rational approximation below sqrt(2) - 1, log above
__device__ __forceinline__ float log1p_xla(float w) {
  const float ws = __fmul_rn(w, w);
  float num = kLog1pNum[0], den = kLog1pDen[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    num = __fmaf_rn(num, w, kLog1pNum[i]);
    den = __fmaf_rn(den, w, kLog1pDen[i]);
  }
  float small = __fmul_rn(__fmul_rn(w, ws), __fdiv_rn(num, den));
  small = __fadd_rn(w, __fmaf_rn(-0.5f, ws, small));
  return fabsf(w) < kLog1pSmall ? small : log_xla(__fadd_rn(w, 1.0f));
}

// XLA's ErfInv32 (Giles' two branches) on (-1, 1)
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1p_xla(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kErfInvLt5[0] : kErfInvGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fmaf_rn(p, w, lt ? kErfInvLt5[i] : kErfInvGe5[i]);
  return __fmul_rn(p, x);
}

__device__ __forceinline__ float value(unsigned bits, int mode, float a,
                                       float span) {
  const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  if (mode == 1) return u < a ? 1.0f : 0.0f;
  const float v = fmaxf(a, __fmaf_rn(u, span, a));
  return mode == 2 ? __fmul_rn(kSqrt2, erf_inv(v)) : v;
}

__global__ void __launch_bounds__(kThreads)
draw_kernel(Keys keys, float* __restrict__ out, long long n, int mode,
            float a, float span) {
  const int row = blockIdx.y;
  const unsigned k0 = keys.k[2 * row], k1 = keys.k[2 * row + 1];
  const long long i0 =
      4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (i0 >= n) return;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned long long i = (unsigned long long)(i0 + j);
    unsigned x0 = (unsigned)(i >> 32), x1 = (unsigned)i;
    threefry(k0, k1, x0, x1);
    v[j] = value(x0 ^ x1, mode, a, span);
  }
  float* dst = out + (long long)row * n + i0;
  if ((n & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < n) dst[j] = v[j];
  }
}

}  // namespace

// keys: (count, 2) uint32 bit patterns on the host, count <= 256. out: (count,
// n) fp32 on the card, 16-byte aligned. mode 0: uniform on [a, a + span) (span
// = b - a rounded to fp32), 1: uniform < a as 0/1, 2: normal (a and span as
// mode 0 with [nextafter(-1, 0), 1)). Returns cudaGetLastError() after the
// launch.
extern "C" int threefry_draw_f32(const unsigned* keys, int count, void* out,
                                 long long n, int mode, float a, float span,
                                 void* stream) {
  if (count <= 0 || n <= 0) return cudaSuccess;
  if (count > kMaxKeys || mode < 0 || mode > 2 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  Keys k;
  for (int i = 0; i < 2 * count; ++i) k.k[i] = keys[i];
  const long long per_block = 4LL * kThreads;
  const long long bx = (n + per_block - 1) / per_block;
  if (bx > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  draw_kernel<<<dim3((unsigned)bx, (unsigned)count), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<float*>(out), n, mode, a, span);
  return cudaGetLastError();
}
