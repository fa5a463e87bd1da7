// The radix-2 Walsh-Hadamard butterfly of one row, shared by the FWHT kernel
// (fwht.cu, B1) and the fused rotate+amax and rotate+quantize kernels
// (ht_quant/csrc/ht_quant.cu, B3 and B4), as the TPU kernels share
// src/repro/kernels/fwht/fwht.py::mxu_rotate_block. One copy of the rotation
// means the fused kernels' rotation is bitwise B1's.
//
// Each row of n = 2^LOG_N fp32 is split over T = 2^floor(LOG_N/2) threads
// holding E = n/T values in registers:
//   1. each thread loads E contiguous values (16-byte loads), applies the
//      optional pre-sign, and runs the butterflies of index bits
//      0..log2(E)-1 in registers;
//   2. one pass through shared memory (padded one word per 32 against bank
//      conflicts) transposes the row so each thread holds the strided values
//      k*T + t;
//   3. the butterflies of bits log2(E)..log2(n)-1 run in registers.
// Bits are applied lowest first, as kernels/fwht/ref.py::fwht_ref does, so the
// output is in Sylvester (natural) order with the plain version's adds.
// normalise() then applies the orthonormal 1/sqrt(n) scale (a multiply by
// a power of two where log2(n) is even).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace butterfly {

constexpr int kThreads = 128;

template <int LOG_N>
struct Shape {
  static constexpr int N = 1 << LOG_N;
  static constexpr int LOG_T = LOG_N / 2;
  static constexpr int LOG_E = LOG_N - LOG_T;
  static constexpr int T = 1 << LOG_T;
  static constexpr int E = 1 << LOG_E;
  static constexpr int ROWS_PER_BLOCK = kThreads / T;
  static constexpr int SLOT = N + N / 32;
  static constexpr size_t kSmemBytes = sizeof(float) * ROWS_PER_BLOCK * SLOT;
};

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Row `row` of a (P, rows_per_peer, n) view whose peer stride is arbitrary
// (0 for a broadcast all_gather view) and whose rows are contiguous.
__device__ __forceinline__ const float* row_ptr(const float* x, long long row,
                                                long long rows_per_peer,
                                                long long peer_stride, int n) {
  const long long peer = row / rows_per_peer;
  const long long r = row % rows_per_peer;
  return x + peer * peer_stride + r * (long long)n;
}

// butterflies of the register-local index bits from FIRST up
template <int LOG_N, int FIRST>
__device__ __forceinline__ void butterfly_pass(float* v) {
  constexpr int E = Shape<LOG_N>::E;
#pragma unroll
  for (int h = FIRST; h < E; h <<= 1) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if ((i & h) == 0) {
        const float a = v[i];
        const float b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
}

// Unnormalised H (d * x) of the row at `src` (d = pre_sign, or none when
// null). On return v[k] holds output index k*T + t of an active thread. Every
// thread of the block must call it: it holds a __syncthreads. Inactive
// threads (a ragged last block) load nothing.
template <int LOG_N>
__device__ __forceinline__ void rotate_row(const float* __restrict__ src,
                                           const float* __restrict__ pre_sign,
                                           float* s, int t, bool active,
                                           float* v) {
  using S = Shape<LOG_N>;
  constexpr int E = S::E;
  constexpr int T = S::T;
  if (active) {
    const float4* p = reinterpret_cast<const float4*>(src + (long long)t * E);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 q = __ldg(p + k);
      v[4 * k + 0] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    if (pre_sign != nullptr) {
      const float4* sg = reinterpret_cast<const float4*>(pre_sign + t * E);
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        const float4 q = __ldg(sg + k);
        v[4 * k + 0] *= q.x;
        v[4 * k + 1] *= q.y;
        v[4 * k + 2] *= q.z;
        v[4 * k + 3] *= q.w;
      }
    }
    // index bits 0..LOG_E-1 live inside one thread's contiguous run
    butterfly_pass<LOG_N, 1>(v);
#pragma unroll
    for (int k = 0; k < E; ++k) s[padded(t * E + k)] = v[k];
  }
  __syncthreads();
  if (!active) return;
  // strided ownership: v[k] is index k*T + t, so index bit LOG_T + j is bit
  // j of k; bits below LOG_E were done above
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = s[padded(k * T + t)];
  butterfly_pass<LOG_N, (1 << (S::LOG_E - S::LOG_T))>(v);
}

// The orthonormal scale, bitwise the plain version's IEEE division by
// sqrt(n). For even log2(n), sqrt(n) is a power of two, so v / sqrt(n) and
// v * 2^(-log2(n)/2) are the correctly rounded value of the same real
// number (subnormals included): one multiply. Odd log2(n) keeps the
// division by the rounded sqrt(n).
template <int LOG_N>
__device__ __forceinline__ float normalise(float v) {
  if constexpr (LOG_N % 2 == 0)
    return __fmul_rn(v, 1.f / (float)(1 << (LOG_N / 2)));
  else
    return __fdiv_rn(v, sqrtf((float)Shape<LOG_N>::N));
}

}  // namespace butterfly

// switch over the row lengths the kernels take (16..4096); CALL(LOG_N) is a
// macro of the including file returning a cudaError_t
#define BUTTERFLY_DISPATCH(n, CALL)             \
  switch (n) {                                  \
    case 16: return CALL(4);                    \
    case 32: return CALL(5);                    \
    case 64: return CALL(6);                    \
    case 128: return CALL(7);                   \
    case 256: return CALL(8);                   \
    case 512: return CALL(9);                   \
    case 1024: return CALL(10);                 \
    case 2048: return CALL(11);                 \
    case 4096: return CALL(12);                 \
    default: return cudaErrorInvalidValue;      \
  }
