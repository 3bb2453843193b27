// Building blocks of the wide-head SIMT kernels: attention at a head dim D
// above what the register-resident wgmma kernels hold (K1 above 256, K2
// above 128), in float32 or bf16, at any D that is a multiple of 64 (the
// Python wrappers zero-pad any other D to the next multiple, with the
// scale of the true D).
//
// Why SIMT: the wgmma kernels keep a 64-row tile of Q (and K) for all D
// columns in shared memory and the output accumulator in one warpgroup's
// registers; at D = 256 the dQ kernel already uses 225 of 227 kB. Here
// nothing grows with D:
//   - a CTA of 256 threads owns 64 rows and one block of kCols = 128
//     output columns (the grid gains a column coordinate, as the D = 256
//     wgmma kernels' ColSplit does), so its accumulators are 4 x 8 floats
//     a thread for any D;
//   - a 64 x 64 score tile (S = A B^T, or dP) is summed over D by
//     streaming 64-column chunks of both operands through shared memory
//     (dot_tile), so the shared memory is the same at D = 320 and 1024;
//   - each column CTA recomputes the score tiles over all D: the price of
//     a fixed footprint, as in the D = 256 wgmma kernels.
// No head dim of the model zoo reaches these kernels; they are the simple
// correct kernels for the rest, with scalar float32 FMA (no tensor cores).
//
// Thread layout: ty = tid / 16 owns tile rows ty + 16 i (i < 4), tx = tid
// % 16 owns columns tx + 16 j. Shared score and chunk tiles have a row of
// kLd = 65 floats, so the 16 tx lanes of a warp read 16 banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int kRows = 64;        // rows a CTA owns; rows a score tile takes
constexpr int kChunk = 64;       // head-dim columns a streamed chunk
constexpr int kCols = 128;       // output columns a CTA owns
constexpr int kThreads = 256;
constexpr int kLd = kChunk + 1;  // leading dim of a shared 64 x 64 tile
constexpr int kScoreTile = kRows * kLd;   // floats of a 64 x 64 shared tile
constexpr int kColTile = kRows * kCols;  // floats of a 64 x 128 column tile

// The CTA's share, from blockIdx.x: row block counted fastest, then the
// column block, then the rest (a head, or a window and head).
struct Share {
  int row0;   // first row: 64 * row block
  int col0;   // first output column: 128 * column block
  int width;  // output columns it owns: min(128, D - col0)
  long long rest;
};

__device__ __forceinline__ Share share(int n_row_blocks, int d) {
  const int n_col = (d + kCols - 1) / kCols;
  const long long x = blockIdx.x;
  const int rb = int(x % n_row_blocks);
  const long long t = x / n_row_blocks;
  const int cb = int(t % n_col);
  return {rb * kRows, cb * kCols, min(kCols, d - cb * kCols), t / n_col};
}

// CTAs of a grid over `rest` units of n_rows rows and d columns, or -1 past
// the grid's 2^31 - 1.
inline long long grid_ctas(long long rest, int n_rows, int d) {
  const long long ctas = rest * ((n_rows + kRows - 1) / kRows) *
                         ((d + kCols - 1) / kCols);
  return ctas > 0x7fffffffLL ? -1 : ctas;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// x rounded to T and back: P (and dS) before the products, as the wgmma
// kernels round their A operands to bf16
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows row0 .. row0 + 63 (zeros at or past n) and columns c0 .. c0 + w - 1
// of a row-major operand with row stride sn (contiguous columns), as float
// into dst with leading dim ld
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long sn, int row0, int n,
                                          int c0, int w) {
  for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
    const int r = i / w, c = i % w;
    dst[r * ld + c] =
        row0 + r < n ? to_f(src[(long long)(row0 + r) * sn + c0 + c]) : 0.f;
  }
}

// acc[i][j] += sum over the d columns of a[a_row0 + ty + 16 i, :] .
// b[b_row0 + tx + 16 j, :] (rows at or past n are zeros), the columns
// streamed 64 at a time through the shared tiles as and bs. Starts with a
// barrier, so the caller's earlier reads of any shared tile are done.
template <typename T>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const T* a,
                                         long long a_sn, int a_row0,
                                         const T* b, long long b_sn,
                                         int b_row0, int n, int d, float* as,
                                         float* bs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    __syncthreads();
    load_tile(as, kLd, a, a_sn, a_row0, n, c0, kChunk);
    load_tile(bs, kLd, b, b_sn, b_row0, n, c0, kChunk);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[(ty + 16 * i) * kLd + c];
        bv[i] = bs[(tx + 16 * i) * kLd + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// out[i][j] += sum over k < 64 of p[ty + 16 i, k] * v[k, tx + 16 j]: p a
// shared 64 x 64 tile (leading dim kLd), v a shared 64 x 128 column tile
template <int J>
__device__ __forceinline__ void pv_tile(float (&out)[4][J], const float* p,
                                        const float* v) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    float pv[4], vv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < J; ++j) vv[j] = v[k * kCols + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) out[i][j] = fmaf(pv[i], vv[j], out[i][j]);
  }
}

// the rows' 64 x w block of out (a 4 x 8 accumulator a thread) times
// row_scale[row] into dst (row stride sn), rows at or past n skipped
template <typename OutT>
__device__ __forceinline__ void store_rows(OutT* dst, long long sn, int row0,
                                          int n, int w, const float (&out)[4][8],
                                          const float* row_scale) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= n) continue;
    const float sc = row_scale ? row_scale[r] : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < w) put(dst + (long long)(row0 + r) * sn + c, out[i][j] * sc);
    }
  }
}

}  // namespace wide
