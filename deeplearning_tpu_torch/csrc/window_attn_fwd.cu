// Fused window attention forward for Hopper (sm_90a): Swin's per-window
// attention with the relative-position bias and the shift mask added inside
// the kernel, never writing the (N, N) score matrix to device memory.
//
// Replaces the TPU Pallas kernel deeplearning_tpu/ops/pallas/window_attention.py
//   _attn_kernel (:43), reached through window_attention (:65-120).
//
// What it computes, per (window w, head h), for any N = window^2:
//   S = (Q K^T) * d^-1/2 + bias[h] + mask[w mod nW]   (float32)
//   P = softmax(S)                                     (float32, rows)
//   O = P' V   with P' = P cast to V's dtype, float32 accumulation,
// written as O[w, n, h*d + c] in the input dtype: the (BW, N, heads*d)
// layout the output projection consumes. The additive term is the same
// float32 sum bias + mask the TPU code forms ahead of its call (comb, :84).
// D is 16, 32, 64 or 128 here, or a multiple of 64 above 128 (the wide
// SIMT kernel, win_wide_simt); the Python wrapper zero-pads any other d to
// the next of them, with the scale of the true d.
//
// Design against the TPU original:
//   - The Pallas call padded N = 49 to 56 with -1e9 keys, moved q/k/v to
//     (BW, heads, Np, d) copies and pre-combined bias and mask into one
//     (lcm(nW, wb), heads, Np, Np) tensor picked per block by an index map.
//     Here q, k and v are read straight from the strided (BW, N, 3, heads,
//     d) view of the qkv projection (no copies), keys >= N are masked in
//     registers, and bias (heads, N, N) and mask (nW, N, N) are separate
//     float32 inputs.
//   - A CTA owns one (head h, window position j) and walks images: window
//     w = img * nW + j for its `windows_per_block` images (unmasked calls
//     have nW = 1). For N <= 64 it forms the additive tile
//     (bias[h] + mask[j]) * log2(e) once, in the registers of the
//     accumulator layout (32 floats a thread), and reuses it for every
//     window it takes: the earlier design re-read bias and mask from L1/L2
//     for every score of every window, more bytes than q, k, v and O.
//   - bf16 (win_bf16_wgmma), the K1 forward's design (hopper.cuh):
//       * 160 threads: one consumer warpgroup that owns a 64-row query tile
//         (warp w rows 16w..16w+15) and one producer warp whose lane 0
//         issues every copy; they meet only on mbarriers.
//       * q, k and v of one head are TMA boxes of 64 rows through rank-4
//         tensor maps of the strided (BW, heads, N, d) views; rows >= N
//         arrive as zeros. A ring of Q slots and K/V stages keeps the next
//         windows' loads in flight while the consumer computes.
//       * S = Q K^T is wgmma m64n64k16 (both operands K-major in shared
//         memory; 49 queries and keys padded to the 64 of a tile, free in a
//         kernel bound by bytes); P, normalised and rounded to bf16, is the
//         register A operand of O = P V, with V read through the
//         descriptor's transpose (MN-major) mode.
//       * O leaves through shared memory as one TMA store a tile (a box of
//         all d columns, no swizzle), two staging buffers in turn; rows >= N
//         are clipped by the copy engine.
//       * N > 64: 64-row query tiles, each walking 64-key tiles twice: the
//         first pass takes the row max and the sum of exp (online), the
//         second normalises P before its bf16 cast and forms P V, the TPU
//         kernel's rounding (it normalises P before the cast, :56-61). The
//         additive term is then read per key tile from L2.
//   - float32 (win_f32_simt): scalar FMA, the same CTA and additive-tile
//     reuse (a 64 x 64 table in shared memory for N <= 64); four (d <= 64)
//     or eight (d = 128) lanes share a query row and split the head
//     dimension. Key tiles of 64 are staged in shared memory and the softmax
//     is online with one division at the end: P' = P in float32, so
//     normalising before or after P V differs by rounding only.
//
// Bound at Swin-T stage 1 (batch b, BW = 64 b windows, N = 49, heads = 3,
// d = 32, bf16): q, k, v read once and O written once move 4 * 64b*49*96*2
// bytes, about 2.41 MB an image, plus the bias and mask tables (0.6 MB, once);
// the products are 4 * 64b*49*49*96, about 59 MFLOP an image. That is ~24
// FLOP/byte, far under the H100's ~295 FLOP/byte ridge, so the kernel is
// bound by device-memory bytes: at b = 128 about 92 us of HBM time against
// 7.6 us of tensor-core time (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s
// bf16 dense, 700 W).
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; window_attn_fwd returns cudaGetLastError() (or
// the error of encoding a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wide_attn.cuh"

namespace {

constexpr int kTile = 64;          // query rows, keys a tile
constexpr float kMasked = -1e30f;  // keys past N
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrGrid = -1;       // more CTAs than the grid holds

struct Params {
  const void* qkv;    // float32 path: q of window 0, row 0, head 0
  const float* bias;  // (H, N, N)
  const float* mask;  // (nW, N, N) or null
  void* o;            // float32 path: (BW, N, H * D), windows o_sw apart, rows o_sn
  int BW, N, H, nW;
  int wb;             // images a CTA takes
  int n_img;          // BW / nW
  long long s_w, s_n, s_3, s_h;  // element strides of the qkv view
  long long o_sw, o_sn;
  float scale_log2;   // d^-1/2 * log2(e): the softmax runs in base 2
};

// The CTA's share: head h, window position j = w mod nW, images
// img0 .. img1 - 1 (window w = img * nW + j). The head is counted fastest,
// then j, so the CTAs in flight cover contiguous windows.
struct Work {
  int h, j, img0, img1;
};

__device__ __forceinline__ Work cta_work(const Params& p) {
  const int h = blockIdx.x % p.H;
  const int r = blockIdx.x / p.H;
  const int img0 = (r / p.nW) * p.wb;
  return {h, r % p.nW, img0, min(p.n_img, img0 + p.wb)};
}

// (bias[h] + mask[j])[row, col] * log2(e); keys >= N never kept; query rows
// >= N (computed, never stored) 0. The loads do not depend on the branch
// (out-of-range elements read element 0), so a caller's unrolled loop
// issues them all before the first one returns.
__device__ __forceinline__ float additive(const Params& p, const float* bias_h,
                                          const float* mask_j, int row, int col) {
  const bool in = row < p.N && col < p.N;
  const long long i = in ? (long long)row * p.N + col : 0;
  const float x = __ldg(bias_h + i) + (mask_j ? __ldg(mask_j + i) : 0.f);
  return col >= p.N ? kMasked : row >= p.N ? 0.f : x * kLog2e;
}

// ---------------------------------------------------------------- bf16 path

struct WinMaps {  // TMA tensor maps of the q, k, v views and of the output
  CUtensorMap q, k, v, o;
};

template <int D>
struct WgmmaCfg {
  using T = hopper::Tile<D>;
  // Q slots and K/V stages: with 3 CTAs an SM, 2 keep enough loads in
  // flight (4 and 5 ran no faster at Swin-T's stages; 2 ran 0-7% faster)
  static constexpr int kStages = 2;
  static constexpr int kThreads = 160;             // consumer warpgroup + producer warp
  static constexpr int kOutBytes = kTile * D * 2;  // one staged output tile
  // CTAs an SM the registers must allow (<= 136 a thread at 3): one tile
  // (N <= 64), 3 at D <= 32, 2 at D = 64, 1 at D = 128; two passes (which
  // also hold m, l and a reloaded additive tile), 2 at D <= 32 (held to 3
  // they spilled), 1 above
  static constexpr int kMinBlocks = D <= 32 ? 3 : D == 64 ? 2 : 1;
  static constexpr int kMinBlocksTwoPass = D <= 32 ? 2 : 1;
  static constexpr size_t kTileBytes =
      size_t(3 * kStages) * T::kBytes + 2 * size_t(kOutBytes);
  static constexpr size_t kSmem = 1024 + kTileBytes + 4 * kStages * sizeof(uint64_t);
};

// the additive term of a (64 queries x 64 keys) tile in the accumulator
// layout: element 4 nb + e at row row0 + r_a + 8 (e / 2), key col0 + 8 nb +
// 2t + (e & 1)
__device__ __forceinline__ void load_additive(float (&add)[32], const Params& p,
                                              const float* bias_h,
                                              const float* mask_j, int row0,
                                              int col0, int r_a, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      add[4 * nb + e] = additive(p, bias_h, mask_j, row0 + r_a + 8 * (e >> 1),
                                 col0 + 8 * nb + 2 * t + (e & 1));
}

// max and sum over the four lanes (t = 0..3) that share a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T of one tile pair, waited for
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q_tile,
                                       uint32_t k_tile) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  hopper::fence_regs(s);
  hopper::wgmma_fence();
  hopper::wgmma_abt<D>(s, q_tile, k_tile);
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::fence_regs(s);
}

// kOne: N <= 64, one query tile and one key tile, the additive tile held
// in registers for the CTA's life; else the two-pass walk over 64-row tiles
// (a separate instantiation, so the one-tile kernel carries none of its
// registers)
template <int D, bool kOne>
__global__ void __launch_bounds__(WgmmaCfg<D>::kThreads,
                                  kOne ? WgmmaCfg<D>::kMinBlocks
                                       : WgmmaCfg<D>::kMinBlocksTwoPass)
    win_bf16_wgmma(const __grid_constant__ WinMaps maps, const Params p) {
  using Cfg = WgmmaCfg<D>;
  using T = hopper::Tile<D>;
  constexpr int NS = Cfg::kStages;
  extern __shared__ __align__(128) unsigned char smem_tma[];
  const uint32_t raw = hopper::smem_addr(smem_tma);
  unsigned char* base = smem_tma + ((1024 - (raw & 1023)) & 1023);
  unsigned char* q_s = base;                   // NS tiles
  unsigned char* k_s = q_s + NS * T::kBytes;   // NS tiles
  unsigned char* v_s = k_s + NS * T::kBytes;   // NS tiles
  unsigned char* o_s = v_s + NS * T::kBytes;   // 2 staged output tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + Cfg::kTileBytes);
  uint64_t* q_empty = q_full + NS;
  uint64_t* kv_full = q_empty + NS;
  uint64_t* kv_empty = kv_full + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 128);
      hopper::mbar_init(&kv_full[i], 1);
      hopper::mbar_init(&kv_empty[i], 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const Work wk = cta_work(p);
  // query tiles = key tiles
  const int n_tiles = kOne ? 1 : (p.N + kTile - 1) / kTile;

  if (warp == 4) {  // ---- producer: one thread keeps the copies in flight
    if (lane == 0) {
      hopper::tma_prefetch(&maps.q);
      hopper::tma_prefetch(&maps.k);
      hopper::tma_prefetch(&maps.v);
      hopper::Ring qr, kr;
      for (int img = wk.img0; img < wk.img1; ++img) {
        const int w = img * p.nW + wk.j;
        for (int qt = 0; qt < n_tiles; ++qt) {
          hopper::mbar_wait(&q_empty[qr.slot], qr.phase ^ 1);
          hopper::mbar_arrive_expect_tx(&q_full[qr.slot], T::kBytes);
          hopper::tma_load_tile<D>(q_s + qr.slot * T::kBytes, &maps.q,
                                   &q_full[qr.slot], qt * kTile, wk.h, w);
          qr.advance(NS);
          // N > 64: the statistics pass reads K alone, then K and V again
          for (int pass = kOne ? 1 : 0; pass < 2; ++pass)
            for (int kt = 0; kt < n_tiles; ++kt) {
              hopper::mbar_wait(&kv_empty[kr.slot], kr.phase ^ 1);
              hopper::mbar_arrive_expect_tx(&kv_full[kr.slot],
                                            (pass + 1) * T::kBytes);
              hopper::tma_load_tile<D>(k_s + kr.slot * T::kBytes, &maps.k,
                                       &kv_full[kr.slot], kt * kTile, wk.h, w);
              if (pass)
                hopper::tma_load_tile<D>(v_s + kr.slot * T::kBytes, &maps.v,
                                         &kv_full[kr.slot], kt * kTile, wk.h, w);
              kr.advance(NS);
            }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns query rows 16w .. 16w + 15
  const int g = lane >> 2, t = lane & 3;
  const int r_a = warp * 16 + g;  // rows r_a and r_a + 8 of the tile
  const float* bias_h = p.bias + (long long)wk.h * p.N * p.N;
  const float* mask_j = p.mask ? p.mask + (long long)wk.j * p.N * p.N : nullptr;
  // N <= 64: the one additive tile, formed once for every window of the CTA
  float add[32];
  if (kOne) load_additive(add, p, bias_h, mask_j, 0, 0, r_a, t);

  hopper::Ring qr, kr;
  int ob = 0;  // the staging buffer of the next output tile
  for (int img = wk.img0; img < wk.img1; ++img) {
    const int w = img * p.nW + wk.j;
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int row0 = qt * kTile;
      hopper::mbar_wait(&q_full[qr.slot], qr.phase);
      const uint32_t q_tile = hopper::smem_addr(q_s + qr.slot * T::kBytes);
      float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
      float s[32];

      if (!kOne) {  // pass 1: row max and sum of exp, online
        for (int kt = 0; kt < n_tiles; ++kt) {
          hopper::mbar_wait(&kv_full[kr.slot], kr.phase);
          scores<D>(s, q_tile, hopper::smem_addr(k_s + kr.slot * T::kBytes));
          hopper::mbar_arrive(&kv_empty[kr.slot]);
          kr.advance(NS);
          load_additive(add, p, bias_h, mask_j, row0, kt * kTile, r_a, t);
          float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            s[i] = fmaf(s[i], p.scale_log2, add[i]);
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
          for (int i = 0; i < 32; ++i) sum[(i >> 1) & 1] += exp2f(s[i] - mx[(i >> 1) & 1]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] = l[r] * exp2f(m[r] - mx[r]) + quad_sum(sum[r]);
            m[r] = mx[r];
          }
        }
      }

      // pass 2 (the only one for N <= 64): P normalised, rounded to bf16,
      // O += P V
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      for (int kt = 0; kt < n_tiles; ++kt) {
        hopper::mbar_wait(&kv_full[kr.slot], kr.phase);
        const uint32_t v_tile = hopper::smem_addr(v_s + kr.slot * T::kBytes);
        scores<D>(s, q_tile, hopper::smem_addr(k_s + kr.slot * T::kBytes));
        if (kt == n_tiles - 1) hopper::mbar_arrive(&q_empty[qr.slot]);
        if (!kOne) load_additive(add, p, bias_h, mask_j, row0, kt * kTile, r_a, t);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = fmaf(s[i], p.scale_log2, add[i]);
        if (kOne) {
#pragma unroll
          for (int i = 0; i < 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
#pragma unroll
          for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
        if (kOne) {
#pragma unroll
          for (int i = 0; i < 32; ++i) l[(i >> 1) & 1] += s[i];
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
        }
        const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= inv[(i >> 1) & 1];

        uint32_t pa[4][4];
        hopper::pack_a(s, pa);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
        hopper::wgmma_xb<D>(o, pa, v_tile);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(o);
        hopper::fence_a(pa);
        hopper::mbar_arrive(&kv_empty[kr.slot]);
        kr.advance(NS);
      }
      qr.advance(NS);

      // O (64 x D, bf16) into a staging buffer, row after row, and out with
      // one TMA store; the store that last read this buffer (two tiles ago)
      // must be done first
      if (threadIdx.x == 0) hopper::bulk_wait_read<1>();
      hopper::named_barrier(1, 128);
      unsigned char* ot = o_s + ob * Cfg::kOutBytes;
#pragma unroll
      for (int db = 0; db < D / 8; ++db)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r_a + 8 * hr, col = db * 8 + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(ot + (row * D + col) * 2) =
              __floats2bfloat162_rn(o[4 * db + 2 * hr], o[4 * db + 2 * hr + 1]);
        }
      hopper::fence_proxy_async();
      hopper::named_barrier(1, 128);
      if (threadIdx.x == 0) {
        hopper::tma_store_4d(&maps.o, ot, 0, row0, wk.h, w);
        hopper::bulk_commit();
      }
      ob ^= 1;
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait_read<0>();
}

// ------------------------------------------------------------- float32 path

template <int D>
struct SimtCfg {
  static constexpr int kTPR = D <= 64 ? 4 : 8;  // lanes sharing one query row
  static constexpr int kPer = D / kTPR;         // head dims a lane owns
  static constexpr int kThreads = 128;
  static constexpr int kRows = kThreads / kTPR;  // query rows at a time
  // the additive table (64 x 64), then one key tile of K and of V
  static constexpr size_t kSmem =
      (size_t(kTile) * kTile + 2 * size_t(kTile) * D) * sizeof(float);
};

// rows row0 .. row0 + 63 of K or V into shared memory; rows >= n are zero
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long sn, int row0, int n,
                                              int tid, int nthreads) {
  constexpr int kVec = 4;  // 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = tid; i < kTile * kPerRow; i += nthreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * sn + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(SimtCfg<D>::kThreads) win_f32_simt(const Params p) {
  using Cfg = SimtCfg<D>;
  constexpr int TPR = Cfg::kTPR, PER = Cfg::kPer, NT = Cfg::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tab = reinterpret_cast<float*>(smem_raw);  // additive, N <= 64
  float* k_s = tab + kTile * kTile;
  float* v_s = k_s + kTile * D;
  const int tid = threadIdx.x, part = tid % TPR, r_in = tid / TPR;
  const Work wk = cta_work(p);
  const int n_tiles = (p.N + kTile - 1) / kTile;
  const bool resident = n_tiles == 1;  // the table holds every score's term
  const float* bias_h = p.bias + (long long)wk.h * p.N * p.N;
  const float* mask_j = p.mask ? p.mask + (long long)wk.j * p.N * p.N : nullptr;
  if (resident)  // ordered before its reads by the first key tile's barrier
#pragma unroll 8
    for (int i = tid; i < kTile * kTile; i += NT)
      tab[i] = additive(p, bias_h, mask_j, i / kTile, i % kTile);

  for (int img = wk.img0; img < wk.img1; ++img) {
    const int w = img * p.nW + wk.j;
    const float* qg = static_cast<const float*>(p.qkv) + (long long)w * p.s_w +
                      (long long)wk.h * p.s_h;
    float* og = static_cast<float*>(p.o) + (long long)w * p.o_sw +
                (long long)wk.h * D;
    for (int r0 = 0; r0 < p.N; r0 += Cfg::kRows) {  // CTA-uniform bound
      const int row = r0 + r_in;
      const bool valid = row < p.N;
      float q[PER], acc[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        q[i] = valid ? qg[(long long)row * p.s_n + part + TPR * i] : 0.f;
        acc[i] = 0.f;
      }
      float m = kMasked, l = 0.f;
      for (int kt = 0; kt < n_tiles; ++kt) {
        if (!resident || r0 == 0) {  // N <= 64: one key tile a window
          __syncthreads();
          load_rows_f32<D>(k_s, qg + p.s_3, p.s_n, kt * kTile, p.N, tid, NT);
          load_rows_f32<D>(v_s, qg + 2 * p.s_3, p.s_n, kt * kTile, p.N, tid, NT);
          __syncthreads();
        }
        float s[kTile];
        float mx = m;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < PER; ++i) x = fmaf(q[i], k_s[j * D + part + TPR * i], x);
#pragma unroll
          for (int sh = 1; sh < TPR; sh <<= 1) x += __shfl_xor_sync(0xffffffffu, x, sh);
          const float a = resident ? tab[row * kTile + j]
                                   : additive(p, bias_h, mask_j, row, kt * kTile + j);
          s[j] = fmaf(x, p.scale_log2, a);
          mx = fmaxf(mx, s[j]);
        }
        const float alpha = exp2f(m - mx);
        m = mx;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const float e = exp2f(s[j] - m);
          sum += e;
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[i] = fmaf(e, v_s[j * D + part + TPR * i], acc[i]);
        }
        l = l * alpha + sum;
      }
      if (valid) {
        const float inv = 1.f / l;
#pragma unroll
        for (int i = 0; i < PER; ++i)
          og[(long long)row * p.o_sn + part + TPR * i] = acc[i] * inv;
      }
    }
  }
}

// ------------------------------------------------- wide path: d above 128

// One CTA a (head h, window position j, 64 query rows, 128 output columns)
// walking its images, either dtype; see wide_attn.cuh. Two passes over the
// 64-key tiles, as win_bf16_wgmma does above 64 tokens: the row max and
// sum (online), then P normalised and rounded to T before P V, the TPU
// kernel's rounding. One key tile (N <= 64): the additive tile is formed
// once in shared memory for all the CTA's windows, and the second pass
// reuses the first's scores; more tiles read it per score from L2.
template <typename T>
__global__ void __launch_bounds__(wide::kThreads)
    win_wide_simt(const Params p, int D) {
  using namespace wide;
  extern __shared__ __align__(16) float wsm[];
  float* as = wsm;
  float* bs = as + kScoreTile;
  float* ss = bs + kScoreTile;          // scores, then P
  float* vs = ss + kScoreTile;          // V's rows, the CTA's columns
  float* add_s = vs + kColTile;    // (bias + mask) * log2 e, one key tile
  float* m_s = add_s + kScoreTile;
  float* l_s = m_s + kRows;

  const int n_rb = (p.N + kRows - 1) / kRows;
  const Share sh = share(n_rb, D);
  const int h = int(sh.rest % p.H);
  const long long r = sh.rest / p.H;
  const int j = int(r % p.nW);
  const int img0 = int(r / p.nW) * p.wb;
  const int img1 = min(p.n_img, img0 + p.wb);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_tiles = (p.N + kRows - 1) / kRows;
  const float* bias_h = p.bias + (long long)h * p.N * p.N;
  const float* mask_j = p.mask ? p.mask + (long long)j * p.N * p.N : nullptr;
  if (n_tiles == 1)
    for (int i = tid; i < kRows * kRows; i += kThreads)
      add_s[(i / kRows) * kLd + i % kRows] =
          additive(p, bias_h, mask_j, sh.row0 + i / kRows, i % kRows);

  for (int img = img0; img < img1; ++img) {
    const long long w = (long long)img * p.nW + j;
    const T* qg = static_cast<const T*>(p.qkv) + w * p.s_w + h * p.s_h;
    const T* kg = qg + p.s_3;
    const T* vg = qg + 2 * p.s_3;
    __syncthreads();  // the last window's reads of m_s, l_s are done
    if (tid < kRows) {
      m_s[tid] = kMasked;
      l_s[tid] = 0.f;
    }
    // scores of key tile kv0 into ss: S * d^-1/2 * log2 e + the additive term
    auto scores = [&](int kv0) {
      float s[4][4] = {};
      dot_tile(s, qg, p.s_n, sh.row0, kg, p.s_n, kv0, p.N, D, as, bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int rr = ty + 16 * i, cc = tx + 16 * jj;
          const float a = n_tiles == 1 ? add_s[rr * kLd + cc]
                                       : additive(p, bias_h, mask_j, sh.row0 + rr, kv0 + cc);
          ss[rr * kLd + cc] = s[i][jj] * p.scale_log2 + a;
        }
      __syncthreads();
    };
    for (int kv0 = 0; kv0 < p.N; kv0 += kRows) {  // pass 1: row max and sum
      scores(kv0);
      const int rr = tid >> 2, c0 = (tid & 3) * 16;
      const float m_old = m_s[rr];
      float mx = m_old;
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, ss[rr * kLd + c0 + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
      for (int c = 0; c < 16; ++c) sum += exp2f(ss[rr * kLd + c0 + c] - mx);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0) {
        l_s[rr] = l_s[rr] * exp2f(m_old - mx) + sum;
        m_s[rr] = mx;
      }
    }
    float o[4][8] = {};
    for (int kv0 = 0; kv0 < p.N; kv0 += kRows) {  // pass 2: P, normalised, V
      if (n_tiles > 1) scores(kv0);
      else __syncthreads();  // pass 1's statistics are in
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int rr = ty + 16 * i, cc = tx + 16 * jj;
          const float e = exp2f(ss[rr * kLd + cc] - m_s[rr]);
          ss[rr * kLd + cc] = round_to<T>(e / fmaxf(l_s[rr], 1e-30f));
        }
      load_tile(vs, kCols, vg, p.s_n, kv0, p.N, sh.col0, sh.width);
      __syncthreads();
      pv_tile(o, ss, vs);
      __syncthreads();  // ss and vs are read; the next tile overwrites them
    }
    T* og = static_cast<T*>(p.o) + w * p.o_sw + (long long)h * D + sh.col0;
    store_rows(og, p.o_sn, sh.row0, p.N, sh.width, o, nullptr);
  }
}

constexpr size_t kWideSmem =
    (4 * wide::kScoreTile + wide::kColTile + 2 * wide::kRows) * sizeof(float);

cudaError_t run_wide(const Params& p, int d, int bf16, cudaStream_t stream) {
  if (d <= 128 || d % wide::kChunk) return cudaErrorInvalidValue;
  const long long chunks = (p.n_img + p.wb - 1) / p.wb;
  const long long ctas = wide::grid_ctas(chunks * p.nW * p.H, p.N, d);
  if (ctas < 0) return static_cast<cudaError_t>(kErrGrid);
  const dim3 grid(static_cast<unsigned>(ctas));
  cudaError_t err;
  if (bf16) {
    err = hopper::allow_smem<win_wide_simt<__nv_bfloat16>>(kWideSmem);
    if (err != cudaSuccess) return err;
    win_wide_simt<__nv_bfloat16><<<grid, wide::kThreads, kWideSmem, stream>>>(p, d);
  } else {
    err = hopper::allow_smem<win_wide_simt<float>>(kWideSmem);
    if (err != cudaSuccess) return err;
    win_wide_simt<float><<<grid, wide::kThreads, kWideSmem, stream>>>(p, d);
  }
  return cudaGetLastError();
}

// ----------------------------------------------------------------- dispatch

template <int D, bool kOne>
cudaError_t run_bf16(const Params& p, unsigned grid, cudaStream_t stream) {
  using C = WgmmaCfg<D>;
  WinMaps maps;
  cudaError_t err = hopper::bind_context();
  const __nv_bfloat16* qkv = static_cast<const __nv_bfloat16*>(p.qkv);
  CUtensorMap* dst[3] = {&maps.q, &maps.k, &maps.v};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = hopper::encode_bhnd(dst[i], qkv + i * p.s_3, p.BW, p.H, p.N, D, p.s_w,
                              p.s_h, p.s_n);
  if (err == cudaSuccess)  // the output, (BW, heads, N, D) with heads D apart
    err = hopper::encode_bhnd(&maps.o, p.o, p.BW, p.H, p.N, D, p.o_sw, D,
                              p.o_sn, false);
  if (err != cudaSuccess) return err;
  err = hopper::allow_smem<win_bf16_wgmma<D, kOne>>(C::kSmem);
  if (err != cudaSuccess) return err;
  win_bf16_wgmma<D, kOne><<<grid, C::kThreads, C::kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const Params& p, unsigned grid, cudaStream_t stream) {
  using C = SimtCfg<D>;
  const cudaError_t err = hopper::allow_smem<win_f32_simt<D>>(C::kSmem);
  if (err != cudaSuccess) return err;
  win_f32_simt<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const Params& p, int bf16, unsigned grid, cudaStream_t stream) {
  if (!bf16) return run_f32<D>(p, grid, stream);
  return p.N <= kTile ? run_bf16<D, true>(p, grid, stream)
                      : run_bf16<D, false>(p, grid, stream);
}

}  // namespace

extern "C" {

// qkv: a (BW, N, 3, H, D) view with element strides (s_w, s_n, s_3, s_h) and
// a contiguous last dim; its base 16-byte aligned and every stride a multiple
// of 16 bytes (the Python wrapper checks). bias: (H, N, N) float32,
// contiguous. mask: (nW, N, N) float32, contiguous, or null (then nW is 1);
// nW divides BW. o: (BW, N, H * D) in qkv's dtype with window stride o_sw
// and row stride o_sn (bf16: both multiples of 8). D in {16, 32, 64, 128}
// or a multiple of 64 above 128, any N. dtype: 0 = float32, 1 = bfloat16.
// windows_per_block: images a CTA takes (window w = img * nW + j of one
// position j and one head). Returns
// cudaGetLastError() after the launch, or kErrGrid when the grid would
// need more CTAs than its x dimension holds.

int window_attn_fwd(const void* qkv, const void* bias, const void* mask,
                    void* o, int BW, int N, int H, int D, int nW,
                    int windows_per_block, long long s_w, long long s_n,
                    long long s_3, long long s_h, long long o_sw,
                    long long o_sn, float scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!mask) nW = 1;
  if (BW < 1 || N < 1 || H < 1 || nW < 1 || BW % nW || windows_per_block < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.qkv = qkv;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.o = o;
  p.BW = BW; p.N = N; p.H = H; p.nW = nW;
  p.wb = windows_per_block;
  p.n_img = BW / nW;
  p.s_w = s_w; p.s_n = s_n; p.s_3 = s_3; p.s_h = s_h;
  p.o_sw = o_sw; p.o_sn = o_sn;
  p.scale_log2 = scale * kLog2e;
  const long long chunks = (p.n_img + p.wb - 1) / p.wb;
  const long long ctas = chunks * nW * H;
  if (ctas > 0x7fffffffLL) return kErrGrid;
  const unsigned grid = unsigned(ctas);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run<16>(p, dtype, grid, s);
    case 32: return run<32>(p, dtype, grid, s);
    case 64: return run<64>(p, dtype, grid, s);
    case 128: return run<128>(p, dtype, grid, s);
    default:  // any multiple of 64 above 128
      return run_wide(p, D, dtype, s);
  }
}

const char* window_attn_error_string(int code) {
  if (code == kErrGrid)
    return "more CTAs than the grid's 2^31 - 1: ceil(BW / nW / "
           "windows_per_block) * nW * H";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
