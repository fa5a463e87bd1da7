// Fused dequantization + drop-compensated mean over peers, for every receiver
// of a bucket at once:
//   v[r, i, j]  = lo[r, j / block] + codes[r, i, j] * step[r, j / block]
//   out[r, j]   = sum_i m[r,i,j] * v[r,i,j] / max(1, sum_i m[r,i,j])  (mask)
//               = sum_i v[r,i,j] / N                                  (none)
// and exactly 0 where, with a mask, no peer delivered column j.
// Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/dequant_reduce/dequant_reduce.py::dequant_masked_mean_pallas
// (bodies _dequant_masked_mean_kernel and _dequant_mean_kernel; a null mask
// selects the second), generalised with a leading receiver axis R.
//
// What bounds it on an H100: bytes. Each column reads N code bytes (and N
// fp32 mask words) and writes one fp32; ~4 flops a code are ~0.8 flop/byte
// with the mask, ~4 without.
//
// Design. The TPU kernel streams (N, TILE) slabs with per-column grid rows
// that its wrapper expanded from the per-block grids
// (dequant_reduce/ops.py:32-34). Here each thread owns 4 adjacent columns of
// one receiver (4-byte code loads, 16-byte mask loads, one 16-byte store),
// so widths, strides and the Hadamard block are multiples of 4, as the sync
// engine's always are. It reads the per-block grids directly: receiver r,
// column j reads lo[r * grid_stride_r + j / block], so no per-column grid is
// ever written.
// The codes may be a strided view (the all_to_all transpose of the peer
// axis): receiver and peer strides are arguments, the columns contiguous.
// Peers are summed in index order; the dequant is __fmul_rn then __fadd_rn
// (no FMA contraction), the plain version's two roundings.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool MASKED>
__global__ void __launch_bounds__(kThreads)
dequant_mean_kernel(const uint8_t* __restrict__ codes,
                    const float* __restrict__ lo,
                    const float* __restrict__ step,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int n, long long len, long long c_stride_r,
                    long long c_stride_n, long long grid_stride_r,
                    int block) {
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  const long long r = blockIdx.y;
  if (col >= len) return;
  // block % 4 == 0: the 4 columns share one Hadamard block's grid
  const long long g = r * grid_stride_r + col / block;
  const float l = __ldg(lo + g);
  const float st = __ldg(step + g);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  const uint8_t* cr = codes + r * c_stride_r + col;
  const float* mr = MASKED ? mask + r * (long long)n * len + col : nullptr;
  for (int i = 0; i < n; ++i) {
    const uchar4 cv = *reinterpret_cast<const uchar4*>(cr + i * c_stride_n);
    const float q[4] = {(float)cv.x, (float)cv.y, (float)cv.z, (float)cv.w};
    float m[4];
    if constexpr (MASKED) {
      const float4 mv = __ldg(reinterpret_cast<const float4*>(mr + i * len));
      m[0] = mv.x; m[1] = mv.y; m[2] = mv.z; m[3] = mv.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __fadd_rn(__fmul_rn(q[e], st), l);
      if constexpr (MASKED) {
        c[e] = __fadd_rn(c[e], m[e]);
        s[e] = __fadd_rn(s[e], __fmul_rn(v, m[e]));
      } else {
        s[e] = __fadd_rn(s[e], v);
      }
    }
  }
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (MASKED)
      o[e] = c[e] > 0.f ? __fdiv_rn(s[e], fmaxf(c[e], 1.f)) : 0.f;
    else
      o[e] = __fdiv_rn(s[e], (float)n);
  }
  *reinterpret_cast<float4*>(out + r * len + col) =
      make_float4(o[0], o[1], o[2], o[3]);
}

template <bool MASKED>
void launch(const uint8_t* codes, const float* lo, const float* step,
            const float* mask, float* out, long long r, int n, long long len,
            long long c_stride_r, long long c_stride_n,
            long long grid_stride_r, int block, cudaStream_t st) {
  const long long threads = len / 4;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)r);
  dequant_mean_kernel<MASKED><<<grid, kThreads, 0, st>>>(
      codes, lo, step, mask, out, n, len, c_stride_r, c_stride_n,
      grid_stride_r, block);
}

}  // namespace

// codes: (R, N, L) uint8 with element (r, i, j) at codes + r*c_stride_r +
// i*c_stride_n + j. lo, step: per-block grids, receiver r's at
// lo + r*grid_stride_r, one per `block` columns. mask: contiguous (R, N, L)
// fp32 0/1 arrivals, or null for the plain mean. out: contiguous (R, L) fp32.
// Each thread takes 4 columns: L, both code strides and block must be
// multiples of 4, codes 4-byte and mask and out 16-byte aligned (the wrapper
// checks the alignments). Returns cudaGetLastError().
extern "C" int dequant_mean_u8(const void* codes, const void* lo,
                               const void* step, const void* mask, void* out,
                               long long r, int n, long long len,
                               long long c_stride_r, long long c_stride_n,
                               long long grid_stride_r, int block,
                               void* stream) {
  if (r == 0 || len == 0) return cudaSuccess;
  if (r > 65535 || n <= 0 || block <= 0 || len % 4 || block % 4 ||
      c_stride_r % 4 || c_stride_n % 4)
    return cudaErrorInvalidValue;
  const uint8_t* cs = static_cast<const uint8_t*>(codes);
  const float* ls = static_cast<const float*>(lo);
  const float* ss = static_cast<const float*>(step);
  const float* ms = static_cast<const float*>(mask);
  float* os = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ms)
    launch<true>(cs, ls, ss, ms, os, r, n, len, c_stride_r, c_stride_n,
                 grid_stride_r, block, st);
  else
    launch<false>(cs, ls, ss, ms, os, r, n, len, c_stride_r, c_stride_n,
                  grid_stride_r, block, st);
  return cudaGetLastError();
}
