// Orthonormal fast Walsh-Hadamard transform over the rows of an fp32 array,
// with the optional randomized-HT sign applied before (encode) or after
// (decode) the rotation. Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/fwht/fwht.py::fwht_pallas (bodies _fwht_kernel,
// _fwht_sign_kernel and mxu_rotate_block).
//
// What bounds it on an H100: bytes. One row of n fp32 is read once and written
// once; the n*log2(n) adds are ~1.25 flop/byte at n = 1024, far below the
// card's ~20 flop/byte fp32 ridge, so the least time is 8*n bytes a row over
// 3.35 TB/s.
//
// Design. The TPU form is two Kronecker-factor matmuls on the MXU; here that
// would run on the tensor cores in TF32 and lose fp32 parity, so the kernel is
// the radix-2 butterfly the paper's GPU build used. Each row is split over
// T = 2^floor(log2(n)/2) threads holding E = n/T values in registers:
//   1. each thread loads E contiguous values (16-byte loads), applies the
//      pre-sign, and runs the butterflies of index bits 0..log2(E)-1 in
//      registers;
//   2. one pass through shared memory (padded one word per 32 against bank
//      conflicts) transposes the row so each thread holds the strided values
//      k*T + t;
//   3. the butterflies of bits log2(E)..log2(n)-1 run in registers, then the
//      1/sqrt(n) scale and the post-sign, and neighbouring threads store
//      neighbouring words (coalesced).
// Bits are applied lowest first, as kernels/fwht/ref.py::fwht_ref does, so
// the output is in Sylvester (natural) order and matches the butterfly
// oracle's arithmetic. Shared memory is one row per row-slot: at most 16.5 KB
// a row (n = 4096), so several blocks fit on an SM and hide the load latency.
//
// Launch shape: 128 threads a block, 128/T rows a block, one grid-stride-free
// block per row group. The input may be a (P, R, n) view whose peer stride is
// arbitrary (0 for a broadcast all_gather view); the output is contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
fwht_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float* __restrict__ sign, long long rows,
                 long long rows_per_peer, long long peer_stride, int mode) {
  constexpr int N = 1 << LOG_N;
  constexpr int LOG_T = LOG_N / 2;
  constexpr int LOG_E = LOG_N - LOG_T;
  constexpr int T = 1 << LOG_T;
  constexpr int E = 1 << LOG_E;
  constexpr int ROWS_PER_BLOCK = kThreads / T;
  constexpr int SLOT = N + N / 32;

  extern __shared__ float smem[];
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + slot;
  const bool active = row < rows;
  float* s = smem + slot * SLOT;

  float v[E];
  if (active) {
    const long long peer = row / rows_per_peer;
    const long long r = row % rows_per_peer;
    const float4* src = reinterpret_cast<const float4*>(
        x + peer * peer_stride + r * (long long)N + (long long)t * E);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 q = __ldg(src + k);
      v[4 * k + 0] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    if (mode == 1) {
      const float4* sg = reinterpret_cast<const float4*>(sign + t * E);
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
#pragma unroll
    for (int h = 1; h < E; h <<= 1) {
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
#pragma unroll
    for (int k = 0; k < E; ++k) s[padded(t * E + k)] = v[k];
  }
  __syncthreads();
  if (!active) return;
  // strided ownership: v[k] is index k*T + t, so index bit LOG_T + j is
  // bit j of k; bits below LOG_E were done above
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = s[padded(k * T + t)];
#pragma unroll
  for (int h = 1 << (LOG_E - LOG_T); h < E; h <<= 1) {
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
  const float root = sqrtf((float)N);
  float* dst = y + row * (long long)N + t;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    float o = v[k] / root;
    if (mode == 2) o *= __ldg(sign + k * T + t);
    dst[k * T] = o;
  }
}

template <int LOG_N>
cudaError_t launch(const float* x, float* y, const float* sign, long long rows,
                   long long rows_per_peer, long long peer_stride, int mode,
                   cudaStream_t stream) {
  constexpr int N = 1 << LOG_N;
  constexpr int T = 1 << (LOG_N / 2);
  constexpr int ROWS_PER_BLOCK = kThreads / T;
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const size_t smem = sizeof(float) * ROWS_PER_BLOCK * (N + N / 32);
  fwht_rows_kernel<LOG_N><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, sign, rows, rows_per_peer, peer_stride, mode);
  return cudaGetLastError();
}

}  // namespace

// x: rows of n fp32; row i starts at x + (i / rows_per_peer) * peer_stride
// + (i % rows_per_peer) * n (16-byte aligned). y: contiguous (rows, n).
// sign: (n,) fp32 or null when mode == 0. mode: 0 none, 1 pre, 2 post.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// length outside 16..4096 or not a power of two.
extern "C" int fwht_f32(const void* x, void* y, const void* sign,
                        long long rows, int n, long long rows_per_peer,
                        long long peer_stride, int mode, void* stream) {
  const float* xs = static_cast<const float*>(x);
  float* ys = static_cast<float*>(y);
  const float* sg = static_cast<const float*>(sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (rows_per_peer <= 0) return cudaErrorInvalidValue;
  switch (n) {
    case 16: return launch<4>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 32: return launch<5>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 64: return launch<6>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 128: return launch<7>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 256: return launch<8>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 512: return launch<9>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 1024: return launch<10>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 2048: return launch<11>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    case 4096: return launch<12>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st);
    default: return cudaErrorInvalidValue;
  }
}
