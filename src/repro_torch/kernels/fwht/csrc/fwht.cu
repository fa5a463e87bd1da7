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
// the radix-2 butterfly the paper's GPU build used, in registers with one
// shared-memory transpose (butterfly.cuh, shared with the fused B3/B4 kernels
// of ht_quant.cu). The output is in Sylvester (natural) order and matches the
// butterfly oracle's arithmetic. Shared memory is one row per row-slot: at
// most 16.5 KB a row (n = 4096), so several blocks fit on an SM and hide the
// load latency.
//
// Launch shape: 128 threads a block, 128/T rows a block, one grid-stride-free
// block per row group. The input may be a (P, R, n) view whose peer stride is
// arbitrary (0 for a broadcast all_gather view); the output is contiguous.
#include "butterfly.cuh"

namespace {

using butterfly::kThreads;

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
fwht_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float* __restrict__ sign, long long rows,
                 long long rows_per_peer, long long peer_stride, int mode) {
  using S = butterfly::Shape<LOG_N>;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / S::T;
  const int t = threadIdx.x % S::T;
  const long long row = (long long)blockIdx.x * S::ROWS_PER_BLOCK + slot;
  const bool active = row < rows;
  float v[S::E];
  butterfly::rotate_row<LOG_N>(
      butterfly::row_ptr(x, row, rows_per_peer, peer_stride, S::N),
      mode == 1 ? sign : nullptr, smem + slot * S::SLOT, t, active, v);
  if (!active) return;
  float* dst = y + row * (long long)S::N + t;
#pragma unroll
  for (int k = 0; k < S::E; ++k) {
    float o = butterfly::normalise<LOG_N>(v[k]);
    if (mode == 2) o *= __ldg(sign + k * S::T + t);
    dst[k * S::T] = o;
  }
}

template <int LOG_N>
cudaError_t launch(const float* x, float* y, const float* sign, long long rows,
                   long long rows_per_peer, long long peer_stride, int mode,
                   cudaStream_t stream) {
  using S = butterfly::Shape<LOG_N>;
  const long long blocks = (rows + S::ROWS_PER_BLOCK - 1) / S::ROWS_PER_BLOCK;
  fwht_rows_kernel<LOG_N><<<(unsigned)blocks, kThreads, S::kSmemBytes,
                            stream>>>(x, y, sign, rows, rows_per_peer,
                                      peer_stride, mode);
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
#define FWHT_CALL(L) \
  launch<L>(xs, ys, sg, rows, rows_per_peer, peer_stride, mode, st)
  BUTTERFLY_DISPATCH(n, FWHT_CALL)
#undef FWHT_CALL
}
