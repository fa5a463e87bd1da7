// Drop-compensated mean over peers: out[r, j] = sum_i m[r,i,j] * x[r,i,j] /
// max(1, sum_i m[r,i,j]), and exactly 0 where no peer delivered column j.
// Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/masked_sum/masked_sum.py::masked_mean_pallas (body
// _masked_mean_kernel, rule compensated_mean_cols), generalised with a
// leading receiver axis R so that one launch reduces a bucket for every
// receiver at once.
//
// What bounds it on an H100: bytes. Each column reads 2*N fp32 (shard and
// mask) and writes one; the 2*N flops a column are ~0.25 flop/byte, so the
// least time is (2*R*N*L + R*L) * 4 bytes over 3.35 TB/s.
//
// Design. The TPU kernel holds an (N, TILE) slab in VMEM; here nothing needs
// to be shared between threads, so each thread owns 4 adjacent columns of one
// receiver, issues 16-byte loads of shard and mask for each of the N peers,
// keeps the count and the masked sum in registers, and writes one 16-byte
// store. The shards may be a strided view (the all_to_all transpose of the
// peer axis): the receiver and peer strides are arguments, the columns are
// contiguous. Peers are summed in index order, as the reference's sum over
// axis 0 does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float compensate(float s, float c) {
  return c > 0.f ? s / fmaxf(c, 1.f) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
masked_mean_vec4(const float* __restrict__ x, const float* __restrict__ m,
                 float* __restrict__ out, int n, long long len,
                 long long x_stride_r, long long x_stride_n) {
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  const long long r = blockIdx.y;
  if (col >= len) return;
  const float* xr = x + r * x_stride_r + col;
  const float* mr = m + r * (long long)n * len + col;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + i * x_stride_n));
    const float4 mv = __ldg(reinterpret_cast<const float4*>(mr + i * len));
    c.x += mv.x; c.y += mv.y; c.z += mv.z; c.w += mv.w;
    s.x += xv.x * mv.x; s.y += xv.y * mv.y;
    s.z += xv.z * mv.z; s.w += xv.w * mv.w;
  }
  float4 o;
  o.x = compensate(s.x, c.x);
  o.y = compensate(s.y, c.y);
  o.z = compensate(s.z, c.z);
  o.w = compensate(s.w, c.w);
  *reinterpret_cast<float4*>(out + r * len + col) = o;
}

__global__ void __launch_bounds__(kThreads)
masked_mean_scalar(const float* __restrict__ x, const float* __restrict__ m,
                   float* __restrict__ out, int n, long long len,
                   long long x_stride_r, long long x_stride_n) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = blockIdx.y;
  if (col >= len) return;
  const float* xr = x + r * x_stride_r + col;
  const float* mr = m + r * (long long)n * len + col;
  float s = 0.f, c = 0.f;
  for (int i = 0; i < n; ++i) {
    const float mv = __ldg(mr + i * len);
    c += mv;
    s += __ldg(xr + i * x_stride_n) * mv;
  }
  out[r * len + col] = compensate(s, c);
}

}  // namespace

// x: (R, N, L) fp32 with element (r, i, j) at x + r*x_stride_r + i*x_stride_n
// + j. m: contiguous (R, N, L) fp32 0/1 mask. out: contiguous (R, L).
// vec4 != 0 takes 16-byte loads and needs L, both strides and every pointer
// 16-byte aligned (the wrapper checks). Returns cudaGetLastError().
extern "C" int masked_mean_f32(const void* x, const void* m, void* out,
                               long long r, int n, long long len,
                               long long x_stride_r, long long x_stride_n,
                               int vec4, void* stream) {
  if (r == 0 || len == 0) return cudaSuccess;
  if (r > 65535 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ms = static_cast<const float*>(m);
  float* os = static_cast<float*>(out);
  if (vec4) {
    const long long groups = len / 4;
    dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)r);
    masked_mean_vec4<<<grid, kThreads, 0, st>>>(xs, ms, os, n, len,
                                                x_stride_r, x_stride_n);
  } else {
    dim3 grid((unsigned)((len + kThreads - 1) / kThreads), (unsigned)r);
    masked_mean_scalar<<<grid, kThreads, 0, st>>>(xs, ms, os, n, len,
                                                  x_stride_r, x_stride_n);
  }
  return cudaGetLastError();
}
