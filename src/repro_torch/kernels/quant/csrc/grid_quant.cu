// Stochastic quantization of fp32 rows onto uniform grids:
// codes[i, c] = clip(floor((x[i, c] - lo) / step + u[i, c]), 0, levels).
// Hopper (sm_90a) ports of two TPU kernels of src/repro/kernels/quant/quant.py:
//
//  * grid_quant_f32 (B6) replaces grid_quant_pallas (body _grid_quant_kernel):
//    one grid (lo_r, step_r) a row, the stage-2 re-quantization of the
//    quantized TAR exchange (HTQuant.encode_shard);
//  * uniform_quant_f32 (B7) replaces uniform_quant_pallas (body
//    _quant_kernel): one range [lo, hi] shared by every row, read from a
//    2-float device operand, with step = (hi - lo) / levels computed in the
//    kernel as the TPU kernel does; the THC baseline's quantizer
//    (core/compression.thc_compress).
//
// What bounds them on an H100: bytes. Each element reads one fp32 of x and
// one of noise and writes one byte; the four flops an element are ~0.4
// flop/byte.
//
// Design. The TPU kernels tile (128, C) row blocks through VMEM; here nothing
// is shared between threads, so each thread quantizes 4 adjacent elements of
// a row (16-byte loads of x and noise, one 4-byte store); the wrappers
// require widths and alignments that allow it. The noise and the grids are
// shared by every peer: one copy of (noise_rows, C) noise and of
// (grid_rows,) lo and step serves all rows, row i reading noise row
// i % noise_rows and grid i % grid_rows, so the wrappers never expand them.
// B7's noise copy is large (one Hadamard-rotated gradient, 0.6 GB at
// gpt2-paper's width, far beyond the 50 MB L2), so a B7 thread loads its 4
// noise values once and walks the rows / noise_rows rows of x that share
// them: the noise is read from memory once, not once a worker. The quantizer
// is written with __fsub_rn, __fdiv_rn and __fadd_rn: a true IEEE division
// and no FMA contraction, so codes are bitwise the plain version's. A NaN
// quotient gives code 0 (fmaxf(NaN, 0) is 0), as in the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t quantize(float x, float l, float st,
                                            float u, float levels) {
  const float q = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(x, l), st), u));
  return (uint8_t)fminf(fmaxf(q, 0.f), levels);
}

__device__ __forceinline__ uchar4 quantize4(const float4 xv, const float4 uv,
                                             float l, float st,
                                             float levels) {
  uchar4 o;
  o.x = quantize(xv.x, l, st, uv.x, levels);
  o.y = quantize(xv.y, l, st, uv.y, levels);
  o.z = quantize(xv.z, l, st, uv.z, levels);
  o.w = quantize(xv.w, l, st, uv.w, levels);
  return o;
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
  *reinterpret_cast<uchar4*>(out + row * cols + col) =
      quantize4(xv, uv, l, st, levels);
}

// Thread i takes the 4 columns at flat offset 4i of the noise copy
// (period4 = noise_rows * cols / 4 such groups) and quantizes the same 4
// columns of each of the `repeats` = rows / noise_rows row groups of x.
__global__ void __launch_bounds__(kThreads)
uniform_quant_kernel(const float4* __restrict__ x,
                     const float4* __restrict__ noise,
                     const float* __restrict__ lohi,
                     uchar4* __restrict__ out, long long period4,
                     long long repeats, float levels) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= period4) return;
  const float lo = __ldg(lohi);
  const float st = __fdiv_rn(__fsub_rn(__ldg(lohi + 1), lo), levels);
  const float4 uv = __ldg(noise + i);
#pragma unroll 4
  for (long long r = 0; r < repeats; ++r) {
    const long long j = r * period4 + i;
    out[j] = quantize4(__ldg(x + j), uv, lo, st, levels);
  }
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

// x: contiguous (rows, cols) fp32. noise: contiguous (noise_rows, cols) fp32,
// noise_rows dividing rows; row i reads noise row i % noise_rows. lohi: 2
// fp32 on the device, [lo, hi]. out: contiguous (rows, cols) uint8. bits:
// 1..8. Each thread takes 4 columns: cols % 4 == 0, x and noise 16-byte and
// out 4-byte aligned (the wrapper checks). Returns cudaGetLastError().
extern "C" int uniform_quant_f32(const void* x, const void* noise,
                                 const void* lohi, void* out, long long rows,
                                 long long cols, long long noise_rows,
                                 int bits, void* stream) {
  if (rows == 0 || cols == 0) return cudaSuccess;
  if (cols % 4 || noise_rows <= 0 || rows % noise_rows || bits < 1 ||
      bits > 8)
    return cudaErrorInvalidValue;
  const long long period4 = noise_rows * (cols / 4);
  uniform_quant_kernel<<<(unsigned)((period4 + kThreads - 1) / kThreads),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(noise),
      static_cast<const float*>(lohi), static_cast<uchar4*>(out), period4,
      rows / noise_rows, (float)((1 << bits) - 1));
  return cudaGetLastError();
}
