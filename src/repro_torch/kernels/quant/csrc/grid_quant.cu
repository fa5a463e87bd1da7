// Stochastic quantization of fp32 rows onto per-row uniform grids:
// codes[i, c] = clip(floor((x[i, c] - lo_r) / step_r + u[i, c]), 0, levels).
// Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/quant/quant.py::grid_quant_pallas (body
// _grid_quant_kernel), the stage-2 re-quantization of the quantized TAR
// exchange (HTQuant.encode_shard).
//
// What bounds it on an H100: bytes. Each element reads one fp32 of x and one
// of noise and writes one byte; the four flops an element are ~0.4 flop/byte.
//
// Design. The TPU kernel tiles (128, C) row blocks through VMEM; here nothing
// is shared between threads, so each thread quantizes 4 adjacent elements of
// one row (16-byte loads of x and noise, one 4-byte store); the wrapper
// requires widths and alignments that allow it. The noise and the grids are shared by every
// peer: one copy of (noise_rows, C) noise and of (grid_rows,) lo and step
// serves all rows, row i reading noise row i % noise_rows and grid
// i % grid_rows, so the wrapper never expands them. The quantizer is written
// with __fsub_rn, __fdiv_rn and __fadd_rn: a true IEEE division and no FMA
// contraction, so codes are bitwise the plain version's. A NaN quotient
// gives code 0 (fmaxf(NaN, 0) is 0), as in the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t quantize(float x, float l, float st,
                                            float u, float levels) {
  const float q = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(x, l), st), u));
  return (uint8_t)fminf(fmaxf(q, 0.f), levels);
}

__global__ void __launch_bounds__(kThreads)
grid_quant_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                  const float* __restrict__ lo, const float* __restrict__ step,
                  uint8_t* __restrict__ out, long long rows, long long cols,
                  long long noise_rows, long long grid_rows, float levels) {
  const long long per_row = cols / 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * per_row) return;
  const long long row = i / per_row;
  const long long col = (i % per_row) * 4;
  const long long g = row % grid_rows;
  const float l = __ldg(lo + g);
  const float st = __ldg(step + g);
  const float4 xv = __ldg(reinterpret_cast<const float4*>(x + row * cols + col));
  const float4 uv = __ldg(
      reinterpret_cast<const float4*>(noise + (row % noise_rows) * cols + col));
  uchar4 o;
  o.x = quantize(xv.x, l, st, uv.x, levels);
  o.y = quantize(xv.y, l, st, uv.y, levels);
  o.z = quantize(xv.z, l, st, uv.z, levels);
  o.w = quantize(xv.w, l, st, uv.w, levels);
  *reinterpret_cast<uchar4*>(out + row * cols + col) = o;
}

}  // namespace

// x: contiguous (rows, cols) fp32. noise: contiguous (noise_rows, cols) fp32;
// lo, step: (grid_rows,) fp32; row i reads noise row i % noise_rows and grid
// i % grid_rows. out: contiguous (rows, cols) uint8. bits: 1..8. Each thread
// takes 4 elements: cols % 4 == 0, x and noise 16-byte and out 4-byte
// aligned (the wrapper checks). Returns cudaGetLastError().
extern "C" int grid_quant_f32(const void* x, const void* noise, const void* lo,
                              const void* step, void* out, long long rows,
                              long long cols, long long noise_rows,
                              long long grid_rows, int bits, void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  if (cols % 4 || noise_rows <= 0 || grid_rows <= 0 || bits < 1 || bits > 8)
    return cudaErrorInvalidValue;
  const long long n = rows * (cols / 4);
  grid_quant_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(lo), static_cast<const float*>(step),
      static_cast<uint8_t*>(out), rows, cols, noise_rows, grid_rows,
      (float)((1 << bits) - 1));
  return cudaGetLastError();
}
