// Fused randomized-Hadamard encode + THC grid pass and quantization over the
// rows (one Hadamard block each) of an fp32 array. Hopper (sm_90a) port of the
// TPU kernels src/repro/kernels/ht_quant/ht_quant.py:
//   ht_amax_f32   <- ht_amax_pallas  (body _ht_amax_kernel): per-row
//                    max |H (d * x)|, the rotated block never written;
//   ht_quant_grouped_f32 <- ht_quant_pallas (body _ht_quant_kernel): uint8
//                    codes clip(floor((H (d * x) - lo_r) / step_r + u), 0,
//                    levels).
//
// What bounds them on an H100. The byte bound: ht_amax reads each fp32 of x
// once and writes one fp32 a row; ht_quant reads x and one shared noise copy
// once and writes one byte an element; the log2(n) adds an element are ~1.4
// flop/byte at n = 1024, far below the fp32 ridge. What they reach is set by
// instruction issue and latency at the occupancy their shared memory allows:
// about 17 instructions an element for the rotation (sign, 10 butterfly
// adds, a shared-memory transpose) and about 20 more for ht_quant's
// quantizer, about 11 of them the IEEE division the bitwise codes need; each resident row holds a
// 4.5 KB staged row (and ht_quant a 4 KB noise row a tile), so an SM keeps
// 24 (ht_amax) or 36 (ht_quant) warps, too few to hide every latency.
//
// Design (each choice measured against its alternative on the H100 with
// tools/kernel_ab.py):
//   * Rows are staged in shared memory by 16-byte cp.async copies. A staged
//     row has 4 words of padding after every 32 (pad4): chunks stay 16-byte
//     aligned, a thread's contiguous run reads and writes as float4 without
//     bank conflicts, and the transposed read k*T + t is conflict-free. The
//     rotation runs in place in the staged row with fwht/csrc/butterfly.cuh's
//     passes (bits lowest first, the same pairs), so it is bitwise B1's
//     encode and the plain fwht_ref's.
//   * ht_amax is a persistent block walking tiles of 128/T rows through a
//     ring of two stages, the next tile's copies in flight while the
//     butterfly runs. ht_quant takes one tile a block with no ring: its
//     larger stage (x and noise) would cut the resident blocks from 9 to 5,
//     which costs more than the prefetch gains.
//   * ht_quant takes rows in grid-major order: rows i with i % G == g (G the
//     Hadamard blocks a peer holds) are adjacent in the walk, so the P peers'
//     rows that share noise row g, lo[g] and step[g] fall in one tile, which
//     copies that noise row into shared memory once: the noise copy is read
//     from memory once, not once a peer, and its latency is hidden with the
//     tile's own copies instead of stalling the quantizer.
//   * The orthonormal scale is exact: for even log2(n) a multiply by a power
//     of two (butterfly::normalise). ht_amax takes the max of the
//     unnormalised |values| and scales once a row: a correctly rounded
//     division by a positive constant is monotone, so this is bitwise the
//     max of the scaled values. The max runs on the bit patterns with the
//     sign cleared (unsigned order is |value| order, and a NaN pattern is
//     above inf), so a NaN in the block gives NaN as torch.amax does.
//   * ht_quant's quantizer is written with __fsub_rn, __fdiv_rn and
//     __fadd_rn: a true IEEE division and no FMA contraction, the plain
//     version's roundings, so codes are bitwise the plain version's. A NaN
//     quotient gives code 0, as in the plain version. Each thread stores its
//     codes as bytes (a warp writes 32 contiguous bytes a store): staging
//     them for 16-byte stores measured slower.
//   * Row, peer and grid indices divide by a multiply and a shift (FastDiv):
//     64-bit division is a long software routine.
// The noise is shared by every peer: one copy of (G, n) serves all rows, as
// the sign is one copy of (n,). So are the grids, one copy of (G,) lo and
// step, or one copy a group where the rows fall in T contiguous groups with
// grids of their own (the tp groups of the peer grid): (T, G), row i of
// group i / (rows / T) reading grid row i % G of its group.
#include <limits.h>

#include "../../fwht/csrc/butterfly.cuh"

namespace {

using butterfly::kThreads;

// tiles a block's ring holds: ht_amax prefetches, ht_quant does not
template <bool QUANT>
constexpr int kStages = QUANT ? 1 : 2;

// ht_quant at n <= 1024 asks for 9 resident blocks (<= 56 registers a
// thread), as many as its shared memory allows
template <int LOG_N, bool QUANT>
constexpr int kMinBlocks = QUANT && butterfly::Shape<LOG_N>::E <= 32 ? 9 : 1;

__device__ __forceinline__ int pad4(int i) { return i + ((i >> 5) << 2); }

// n / d for n < 2^31 by a multiply and a shift (the magic-number division
// of CUTLASS's FastDivmod).
struct FastDiv {
  unsigned d, mul, shr;

  static FastDiv of(unsigned d) {
    FastDiv f{d, 0, 0};
    if (d > 1) {
      unsigned l = 0;                     // ceil(log2(d))
      while ((1ull << l) < d) ++l;
      f.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
      f.shr = l - 1;
    }
    return f;
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

template <int LOG_N>
struct Plan {
  using S = butterfly::Shape<LOG_N>;
  static constexpr int N = S::N;
  static constexpr int T = S::T;
  static constexpr int E = S::E;
  static constexpr int ROWS = S::ROWS_PER_BLOCK;     // rows a tile
  static constexpr int XROW = N + ((N >> 5) << 2);   // floats a staged row
};

// The walk over the rows of a (P, rows_per_peer, n) view: step j of the walk
// is row (j % rep) * grid_rows + j / rep, which reads grid row j / rep, so
// the rep = rows / grid_rows rows sharing a grid row are adjacent. ht_amax
// walks in row order (rep = 1).
struct Walk {
  const float* x;
  long long peer_stride;
  unsigned rows, grid_rows;
  FastDiv rep, per_peer;
  int noise_rows;          // noise rows a stage holds (ht_quant)
  FastDiv group_rows;      // rows a grid group holds (ht_quant)
  unsigned sign_groups;    // sign rows: row i reads sign row i % these

  __device__ __forceinline__ unsigned grid(unsigned j) const {
    return rep.div(j);
  }
  __device__ __forceinline__ unsigned row(unsigned j) const {
    const unsigned g = rep.div(j);
    return (j - g * rep.d) * grid_rows + g;
  }
  template <int N>
  __device__ __forceinline__ const float* src(unsigned row) const {
    const unsigned peer = per_peer.div(row);
    return x + peer * peer_stride + (long long)(row - peer * per_peer.d) * N;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A stage: ROWS staged rows of x, then (ht_quant) noise_rows rows of noise,
// the tile's first grid row onwards.
template <int LOG_N>
__host__ __device__ constexpr int stage_floats(int noise_rows) {
  return Plan<LOG_N>::ROWS * Plan<LOG_N>::XROW + noise_rows * Plan<LOG_N>::N;
}

// The T threads of a slot copy its row of the tile into the stage, 16 bytes
// a copy, neighbouring threads on neighbouring chunks; the block copies the
// tile's noise rows.
template <int LOG_N, bool QUANT>
__device__ __forceinline__ void load_tile(const Walk& w, unsigned tile,
                                          float* stage, const float* noise,
                                          int slot, int t) {
  using P = Plan<LOG_N>;
  const unsigned j = tile * P::ROWS + slot;
  if (j < w.rows) {
    const float* src = w.src<P::N>(w.row(j));
    float* dst = stage + slot * P::XROW;
#pragma unroll
    for (int m = 0; m < P::E / 4; ++m) {
      const int c = 4 * (m * P::T + t);
      cp_async16(dst + pad4(c), src + c);
    }
  }
  if constexpr (QUANT) {
    const unsigned g0 = w.grid(tile * P::ROWS);
    const unsigned rows_left = w.grid_rows - g0;
    const int nr = rows_left < (unsigned)w.noise_rows ? (int)rows_left
                                                      : w.noise_rows;
    const float* src = noise + (long long)g0 * P::N;
    float* dst = stage + P::ROWS * P::XROW;
    for (int c = threadIdx.x; c < nr * P::N / 4; c += kThreads)
      cp_async16(dst + 4 * c, src + 4 * c);
  }
}

// Orders the threads of one row: a warp barrier where a row lies within one
// warp, the block's at n = 4096 (two warps a row).
template <int T>
__device__ __forceinline__ void row_sync() {
  if constexpr (T <= 32)
    __syncwarp();
  else
    __syncthreads();
}

template <int LOG_N, bool QUANT>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<LOG_N, QUANT>))
ht_kernel(Walk w, const float* __restrict__ sign,
          const float* __restrict__ noise, const float* __restrict__ lo,
          const float* __restrict__ step, float* __restrict__ amax_out,
          uint8_t* __restrict__ codes_out, float levels) {
  using P = Plan<LOG_N>;
  using S = typename P::S;
  constexpr int N = P::N, T = P::T, E = P::E;
  constexpr int kRing = kStages<QUANT>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  __shared__ unsigned partial[kThreads / 32];
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const int stage_len = stage_floats<LOG_N>(w.noise_rows);
  const unsigned tiles = (w.rows + P::ROWS - 1) / P::ROWS;
  const unsigned stride = gridDim.x;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    const unsigned tile = blockIdx.x + s * stride;
    if (tile < tiles)
      load_tile<LOG_N, QUANT>(w, tile, xs + s * stage_len, noise, slot, t);
    cp_async_commit();
  }
  int it = 0;
  for (unsigned tile = blockIdx.x; tile < tiles; tile += stride, ++it) {
    if constexpr (kRing == 1) {
      __syncthreads();               // the previous tile is done with it
      load_tile<LOG_N, QUANT>(w, tile, xs, noise, slot, t);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      // this tile's copies have landed, and every thread is done with the
      // stage the next copies overwrite (the previous tile's)
      cp_async_wait<kRing - 2>();
      __syncthreads();
      const unsigned ahead = tile + (kRing - 1) * stride;
      if (ahead < tiles)
        load_tile<LOG_N, QUANT>(
            w, ahead, xs + ((it + kRing - 1) % kRing) * stage_len, noise,
            slot, t);
      cp_async_commit();
    }

    float* stage = xs + (it % kRing) * stage_len;
    float* xr = stage + slot * P::XROW;
    const unsigned j = tile * P::ROWS + slot;
    const bool active = j < w.rows;
    float v[E];
    if (active) {
      // the contiguous run t*E.., signed; index bits 0..LOG_E-1 in registers
      const float* srow =
          w.sign_groups > 1
              ? sign + (size_t)(w.row(j) % w.sign_groups) * N
              : sign;
      const float4* sg = reinterpret_cast<const float4*>(srow + t * E);
#pragma unroll
      for (int m = 0; m < E / 4; ++m) {
        const float4 q =
            *reinterpret_cast<const float4*>(xr + pad4(t * E + 4 * m));
        const float4 d = __ldg(sg + m);
        v[4 * m + 0] = __fmul_rn(q.x, d.x);
        v[4 * m + 1] = __fmul_rn(q.y, d.y);
        v[4 * m + 2] = __fmul_rn(q.z, d.z);
        v[4 * m + 3] = __fmul_rn(q.w, d.w);
      }
      butterfly::butterfly_pass<LOG_N, 1>(v);
#pragma unroll
      for (int m = 0; m < E / 4; ++m)
        *reinterpret_cast<float4*>(xr + pad4(t * E + 4 * m)) = make_float4(
            v[4 * m + 0], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
    }
    row_sync<T>();
    if (active) {
      // strided ownership: v[k] is index k*T + t; the remaining bits
#pragma unroll
      for (int k = 0; k < E; ++k) v[k] = xr[pad4(k * T + t)];
      butterfly::butterfly_pass<LOG_N, (1 << (S::LOG_E - S::LOG_T))>(v);
    }

    if constexpr (QUANT) {
      if (active) {
        const unsigned g = w.grid(j);
        const unsigned grid = w.group_rows.div(w.row(j)) * w.grid_rows + g;
        const float l = __ldg(lo + grid);
        const float st = __ldg(step + grid);
        const float* u =
            stage + P::ROWS * P::XROW + (g - w.grid(tile * P::ROWS)) * N + t;
        uint8_t* dst = codes_out + (long long)w.row(j) * N + t;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float y = butterfly::normalise<LOG_N>(v[k]);
          const float q =
              floorf(__fadd_rn(__fdiv_rn(__fsub_rn(y, l), st), u[k * T]));
          // fmaxf(NaN, 0) is 0: a NaN quotient gives code 0
          dst[k * T] = (uint8_t)fminf(fmaxf(q, 0.f), levels);
        }
      }
    } else {
      // max |v| on the bit patterns, sign cleared: NaN > inf > finite
      unsigned m = 0;
      if (active) {
#pragma unroll
        for (int k = 0; k < E; ++k)
          m = max(m, __float_as_uint(v[k]) & 0x7fffffffu);
      }
      // every lane takes part in the shuffles (inactive rows carry 0); a
      // row's T threads are an aligned group of one warp, or whole warps
      constexpr int W = T < 32 ? T : 32;
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      if constexpr (T > 32) {
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) partial[warp] = m;
        __syncthreads();
        if (t == 0) {
#pragma unroll
          for (int k = 1; k < T / 32; ++k) m = max(m, partial[warp + k]);
        }
      }
      if (t == 0 && active)
        amax_out[w.row(j)] = butterfly::normalise<LOG_N>(__uint_as_float(m));
    }
  }
}

// Blocks of this kernel resident on the whole card at once (the persistent
// grid) for a shared-memory size, per device; raises the kernel's dynamic
// shared memory limit where a block needs more than 48 KB (n >= 2048).
template <int LOG_N, bool QUANT>
cudaError_t resident_blocks(size_t smem, int* out) {
  static int cached[64][2] = {};      // device -> {smem, blocks}
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev][1] > 0 && cached[dev][0] == (int)smem) {
    *out = cached[dev][1];
    return cudaSuccess;
  }
  auto kernel = ht_kernel<LOG_N, QUANT>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) {
    cached[dev][0] = (int)smem;
    cached[dev][1] = *out;
  }
  return cudaSuccess;
}

template <int LOG_N, bool QUANT>
cudaError_t launch(Walk w, const float* sign, const float* noise,
                   const float* lo, const float* step, float* amax_out,
                   uint8_t* codes_out, float levels, cudaStream_t stream) {
  using P = Plan<LOG_N>;
  // noise rows a tile needs: the grid rows of ROWS adjacent steps, one when
  // a grid row's steps fill whole tiles
  const unsigned rep = w.rep.d;
  const unsigned span = (P::ROWS - 2 + rep) / rep + 1;
  w.noise_rows = !QUANT                ? 0
                 : rep % P::ROWS == 0 ? 1
                 : span < (unsigned)P::ROWS ? (int)span
                                            : P::ROWS;
  const size_t smem = sizeof(float) * kStages<QUANT> *
                      (size_t)stage_floats<LOG_N>(w.noise_rows);
  int resident = 0;
  cudaError_t err = resident_blocks<LOG_N, QUANT>(smem, &resident);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (w.rows + P::ROWS - 1) / P::ROWS;
  const unsigned blocks =
      kStages<QUANT> == 1 || tiles < (unsigned)resident ? tiles : resident;
  ht_kernel<LOG_N, QUANT><<<blocks, kThreads, smem, stream>>>(
      w, sign, noise, lo, step, amax_out, codes_out, levels);
  return cudaGetLastError();
}

}  // namespace

// x: rows of n fp32; row i starts at x + (i / rows_per_peer) * peer_stride
// + (i % rows_per_peer) * n (16-byte aligned). sign: (sign_groups, n) fp32,
// 16-byte aligned; row i reads sign row i % sign_groups (one row: (n,)).
// out: (rows,) fp32. rows < 2^31. Returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue for a length outside 16..4096 or not a
// power of two.
extern "C" int ht_amax_f32(const void* x, const void* sign, void* out,
                           long long rows, int n, long long rows_per_peer,
                           long long peer_stride, int sign_groups,
                           void* stream) {
  const float* sg = static_cast<const float*>(sign);
  float* os = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || rows > INT_MAX || rows_per_peer <= 0 || sg == nullptr ||
      sign_groups <= 0)
    return cudaErrorInvalidValue;
  const Walk w{static_cast<const float*>(x), peer_stride, (unsigned)rows,
               (unsigned)rows, FastDiv::of(1),
               FastDiv::of((unsigned)rows_per_peer), 0, FastDiv::of(1),
               (unsigned)sign_groups};
#define AMAX_CALL(L) \
  launch<L, false>(w, sg, nullptr, nullptr, nullptr, os, nullptr, 0.f, st)
  BUTTERFLY_DISPATCH(n, AMAX_CALL)
#undef AMAX_CALL
}

// x, sign: as ht_amax_f32. noise: contiguous (grid_rows, n) fp32, 16-byte
// aligned; lo, step: (groups, grid_rows) fp32; row i reads noise row i %
// grid_rows and the lo and step of that grid row in group i / (rows /
// groups), grid_rows dividing rows_per_peer and rows / groups; sign rows as
// in ht_amax_f32. out: contiguous (rows, n) uint8. bits: 1..8.
extern "C" int ht_quant_grouped_f32(const void* x, const void* sign,
                                    const void* noise, const void* lo,
                                    const void* step, void* out,
                                    long long rows, int n,
                                    long long rows_per_peer,
                                    long long peer_stride,
                                    long long grid_rows, long long groups,
                                    int bits, int sign_groups,
                                    void* stream) {
  const float* sg = static_cast<const float*>(sign);
  const float* ns = static_cast<const float*>(noise);
  const float* ls = static_cast<const float*>(lo);
  const float* ss = static_cast<const float*>(step);
  uint8_t* os = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || rows > INT_MAX || rows_per_peer <= 0 || grid_rows <= 0 ||
      groups <= 0 || rows % groups || rows_per_peer % grid_rows ||
      (rows / groups) % grid_rows || bits < 1 || bits > 8 ||
      sg == nullptr || reinterpret_cast<uintptr_t>(noise) % 16 ||
      sign_groups <= 0)
    return cudaErrorInvalidValue;
  const Walk w{static_cast<const float*>(x), peer_stride, (unsigned)rows,
               (unsigned)grid_rows, FastDiv::of((unsigned)(rows / grid_rows)),
               FastDiv::of((unsigned)rows_per_peer), 0,
               FastDiv::of((unsigned)(rows / groups)), (unsigned)sign_groups};
  const float levels = (float)((1 << bits) - 1);
#define QUANT_CALL(L) \
  launch<L, true>(w, sg, ns, ls, ss, nullptr, os, levels, st)
  BUTTERFLY_DISPATCH(n, QUANT_CALL)
#undef QUANT_CALL
}
