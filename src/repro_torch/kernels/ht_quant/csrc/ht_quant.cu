// Fused randomized-Hadamard encode + THC grid pass and quantization over the
// rows (one Hadamard block each) of an fp32 array. Hopper (sm_90a) port of the
// TPU kernels src/repro/kernels/ht_quant/ht_quant.py:
//   ht_amax_f32   <- ht_amax_pallas  (body _ht_amax_kernel): per-row
//                    max |H (d * x)|, the rotated block never written;
//   ht_quant_f32  <- ht_quant_pallas (body _ht_quant_kernel): uint8 codes
//                    clip(floor((H (d * x) - lo_r) / step_r + u), 0, levels).
//
// What bounds them on an H100: bytes. ht_amax reads each fp32 of x once and
// writes one fp32 a row; ht_quant reads x and the noise once and writes one
// byte an element. The log2(n) adds an element are ~1.4 flop/byte at
// n = 1024, far below the card's ~20 flop/byte fp32 ridge.
//
// Design. The TPU kernels share one rotation body with the FWHT kernel
// (mxu_rotate_block); here both share fwht/csrc/butterfly.cuh with fwht.cu,
// so the rotation is bitwise B1's encode, and only the epilogue differs:
//   ht_amax  the T threads of a row reduce their |values| with warp shuffles
//            (and one shared-memory step where a row spans two warps, n =
//            4096). Max is exact in any order. It passes NaN through, as
//            torch.amax and jnp.max do (fmaxf would drop it): a NaN or inf
//            in a gradient spreads over its block in the butterfly, and the
//            block's grid must then come out NaN, not finite.
//   ht_quant each thread quantizes the values it holds (index k*T + t, so
//            neighbouring threads store neighbouring bytes). The quantizer is
//            written with __fsub_rn, __fdiv_rn and __fadd_rn: a true IEEE
//            division and no FMA contraction, the plain version's two
//            roundings, so codes are bitwise the plain version's. A NaN
//            quotient gives code 0, as in the plain version.
// The grids and the noise are shared by every peer: one copy of (G,) lo and
// step and of (G, n) noise serves all rows, row i reading row i % G (G is the
// number of Hadamard blocks a peer holds), as the sign is one copy of (n,).
#include "../../fwht/csrc/butterfly.cuh"

namespace {

using butterfly::kThreads;

// max that passes NaN through (either operand), where fmaxf drops it
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
ht_amax_kernel(const float* __restrict__ x, const float* __restrict__ sign,
               float* __restrict__ out, long long rows,
               long long rows_per_peer, long long peer_stride) {
  using S = butterfly::Shape<LOG_N>;
  extern __shared__ float smem[];
  __shared__ float partial[kThreads / 32];
  const int slot = threadIdx.x / S::T;
  const int t = threadIdx.x % S::T;
  const long long row = (long long)blockIdx.x * S::ROWS_PER_BLOCK + slot;
  const bool active = row < rows;
  float v[S::E];
  butterfly::rotate_row<LOG_N>(
      butterfly::row_ptr(x, row, rows_per_peer, peer_stride, S::N), sign,
      smem + slot * S::SLOT, t, active, v);
  float m = 0.f;
  if (active) {
#pragma unroll
    for (int k = 0; k < S::E; ++k)
      m = nan_max(m, fabsf(butterfly::normalise<LOG_N>(v[k])));
  }
  // every lane takes part in the shuffles (inactive rows carry 0); a row's
  // T threads are an aligned group of one warp, or two whole warps
  constexpr int W = S::T < 32 ? S::T : 32;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if constexpr (S::T > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) partial[warp] = m;
    __syncthreads();
    if (t == 0 && active) {
#pragma unroll
      for (int w = 1; w < S::T / 32; ++w) m = nan_max(m, partial[warp + w]);
      out[row] = m;
    }
  } else {
    if (t == 0 && active) out[row] = m;
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
ht_quant_kernel(const float* __restrict__ x, const float* __restrict__ sign,
                const float* __restrict__ noise, const float* __restrict__ lo,
                const float* __restrict__ step, uint8_t* __restrict__ out,
                long long rows, long long rows_per_peer,
                long long peer_stride, long long grid_rows, float levels) {
  using S = butterfly::Shape<LOG_N>;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / S::T;
  const int t = threadIdx.x % S::T;
  const long long row = (long long)blockIdx.x * S::ROWS_PER_BLOCK + slot;
  const bool active = row < rows;
  float v[S::E];
  butterfly::rotate_row<LOG_N>(
      butterfly::row_ptr(x, row, rows_per_peer, peer_stride, S::N), sign,
      smem + slot * S::SLOT, t, active, v);
  if (!active) return;
  const long long g = row % grid_rows;
  const float l = __ldg(lo + g);
  const float st = __ldg(step + g);
  const float* u = noise + g * (long long)S::N + t;
  uint8_t* dst = out + row * (long long)S::N + t;
#pragma unroll
  for (int k = 0; k < S::E; ++k) {
    const float y = butterfly::normalise<LOG_N>(v[k]);
    const float q = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(y, l), st),
                                     __ldg(u + k * S::T)));
    // fmaxf(NaN, 0) is 0: a NaN quotient gives code 0
    dst[k * S::T] = (uint8_t)fminf(fmaxf(q, 0.f), levels);
  }
}

template <int LOG_N>
cudaError_t launch_amax(const float* x, const float* sign, float* out,
                        long long rows, long long rows_per_peer,
                        long long peer_stride, cudaStream_t stream) {
  using S = butterfly::Shape<LOG_N>;
  const long long blocks = (rows + S::ROWS_PER_BLOCK - 1) / S::ROWS_PER_BLOCK;
  ht_amax_kernel<LOG_N><<<(unsigned)blocks, kThreads, S::kSmemBytes,
                          stream>>>(x, sign, out, rows, rows_per_peer,
                                    peer_stride);
  return cudaGetLastError();
}

template <int LOG_N>
cudaError_t launch_quant(const float* x, const float* sign, const float* noise,
                         const float* lo, const float* step, uint8_t* out,
                         long long rows, long long rows_per_peer,
                         long long peer_stride, long long grid_rows,
                         float levels, cudaStream_t stream) {
  using S = butterfly::Shape<LOG_N>;
  const long long blocks = (rows + S::ROWS_PER_BLOCK - 1) / S::ROWS_PER_BLOCK;
  ht_quant_kernel<LOG_N><<<(unsigned)blocks, kThreads, S::kSmemBytes,
                           stream>>>(x, sign, noise, lo, step, out, rows,
                                     rows_per_peer, peer_stride, grid_rows,
                                     levels);
  return cudaGetLastError();
}

}  // namespace

// x: rows of n fp32; row i starts at x + (i / rows_per_peer) * peer_stride
// + (i % rows_per_peer) * n (16-byte aligned). sign: (n,) fp32, 16-byte
// aligned. out: (rows,) fp32. Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a length outside 16..4096 or not a power of two.
extern "C" int ht_amax_f32(const void* x, const void* sign, void* out,
                           long long rows, int n, long long rows_per_peer,
                           long long peer_stride, void* stream) {
  const float* xs = static_cast<const float*>(x);
  const float* sg = static_cast<const float*>(sign);
  float* os = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (rows_per_peer <= 0 || sg == nullptr) return cudaErrorInvalidValue;
#define AMAX_CALL(L) \
  launch_amax<L>(xs, sg, os, rows, rows_per_peer, peer_stride, st)
  BUTTERFLY_DISPATCH(n, AMAX_CALL)
#undef AMAX_CALL
}

// x, sign: as ht_amax_f32. noise: contiguous (grid_rows, n) fp32; lo, step:
// (grid_rows,) fp32; row i reads noise, lo and step row i % grid_rows.
// out: contiguous (rows, n) uint8. bits: 1..8.
extern "C" int ht_quant_f32(const void* x, const void* sign, const void* noise,
                            const void* lo, const void* step, void* out,
                            long long rows, int n, long long rows_per_peer,
                            long long peer_stride, long long grid_rows,
                            int bits, void* stream) {
  const float* xs = static_cast<const float*>(x);
  const float* sg = static_cast<const float*>(sign);
  const float* ns = static_cast<const float*>(noise);
  const float* ls = static_cast<const float*>(lo);
  const float* ss = static_cast<const float*>(step);
  uint8_t* os = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (rows_per_peer <= 0 || grid_rows <= 0 || bits < 1 || bits > 8 ||
      sg == nullptr)
    return cudaErrorInvalidValue;
  const float levels = (float)((1 << bits) - 1);
#define QUANT_CALL(L)                                                      \
  launch_quant<L>(xs, sg, ns, ls, ss, os, rows, rows_per_peer, peer_stride, \
                  grid_rows, levels, st)
  BUTTERFLY_DISPATCH(n, QUANT_CALL)
#undef QUANT_CALL
}
