// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// gradients, recomputing the probabilities tile by tile from the forward's
// row log-sum-exp so the (N, N) score matrix never reaches device memory.
//
// Replaces the TPU Pallas kernels in deeplearning_tpu/ops/pallas/flash_attention.py:
//   _bwd_dq_kernel      (:84)  -- dQ, one head per program       -> bwd_dq,  HPC = 1
//   _bwd_dkv_kernel     (:122) -- dK and dV, one head per program -> bwd_dkv, HPC = 1
//   _bwd_dq_kernel_hb   (:214) -- dQ, head_block heads a program  -> bwd_dq,  HPC = 2, 4
//   _bwd_dkv_kernel_hb  (:252) -- dK/dV, head_block heads         -> bwd_dkv, HPC = 2, 4
// One source, one template parameter (heads per CTA, "HPC") for both forms,
// as csrc/flash_attn_fwd.cu does for the forward.
//
// What it computes, per (batch, head), with S = Q K^T * sm_scale masked
// (keys at or past N, and keys past the query row when causal):
//   P     = exp(S - LSE)                   (LSE from the forward, per row)
//   dP    = dO V^T
//   dS    = P o (dP - delta) * sm_scale    (delta = rowsum(dO o O), per row)
//   dQ    = sum over key tiles of dS K             -- bwd_dq kernel
//   dV    = sum over query tiles of P^T dO         -- bwd_dkv kernel
//   dK    = sum over query tiles of dS^T Q         -- bwd_dkv kernel
// Two kernels, as on the TPU: each output element is owned by one CTA and
// summed in registers, so there are no atomics and the gradients are
// deterministic. LSE and delta are plain (B*H, N) float32 arrays. The bf16
// dQ kernel, launched first, computes delta itself from O and dO and
// writes it for the dK/dV kernel (the TPU code computes it outside its
// kernels); given no O (ring attention passes a global delta), and on the
// float32 path, it reads delta instead.
//
// Design against the TPU original:
//   - The Pallas grid padded N to a block multiple (zero rows of dO made the
//     padded queries harmless). Here nothing is padded: the dQ kernel masks
//     key columns >= N, and the dK/dV kernel masks query columns >= N
//     (P = 0 there, and no LSE or delta row past N is ever read; Q and dO
//     rows past N arrive as zeros from the copy engine).
//   - The grid is (B*H / HPC, row blocks), the head groups on grid.x so no
//     batch overflows it (hopper::grid_tile). D is 16, 32, 64 or 128; the
//     Python wrapper zero-pads any other D <= 128 (exact: zero columns add
//     nothing to Q K^T, dO V^T or rowsum(dO o O)).
//   - bf16, both kernels built for Hopper alike (helpers in hopper.cuh):
//       * 160 threads: one consumer warpgroup that owns the CTA's 64 rows
//         (warp w rows 16w..16w+15: query rows in dQ, key rows in dK/dV)
//         and one producer warp whose lane 0 issues the TMA loads.
//       * The tiles the CTA's rows own are loaded once per head into one
//         of 2 slots (the next head's arrive under this one's products);
//         the other operand's 64-row tiles stream through a ring of 2
//         stages. "full" mbarriers wait for the copies, "empty" ones for
//         the 128 consumers.
//       * dQ (bwd_dq_bf16_wgmma): Q and dO are the CTA's tiles, K and V
//         stream. S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both
//         operands in shared memory (K-major descriptors); dS is formed in
//         registers, rounded to bf16 and is the register A operand of
//         dQ += dS K, wgmma m64nDk16 with K read through the descriptor's
//         transpose (MN-major) mode. The head's O tile is loaded beside dO
//         into one slot of its own, released as soon as delta is summed:
//         TMA's swizzle permutes 16-byte chunks within a row, the same way
//         in both tiles, so a row's dO o O products are summed in place.
//         One 64 x D float32 accumulator; causal: the walk stops at the
//         key tile past the block's last row.
//       * dK/dV (bwd_dkv_bf16_wgmma): K and V are the CTA's tiles; Q, dO
//         and the tile's LSE (times log2 e) and delta stream (the producer
//         warp's lanes stage the statistics beside the copies, so a
//         stage's "full" mbarrier counts one arrival carrying the copies'
//         bytes plus 32). S^T = K Q^T and dP^T = V dO^T come out with keys
//         as rows, are rounded to bf16 in registers and are the A operands
//         of dV += P^T dO and dK += dS^T Q, with dO and Q read through the
//         transpose mode. Two 64 x D float32 accumulators. Causal: the walk
//         starts at the query tile of the block's first key.
//       * Swizzle (128/64/32-byte), tiles on 1024-byte boundaries, tensor
//         maps and heads_per_cta (heads walked in sequence by one CTA, not
//         more threads) as in the forward. ptxas reports no spills.
//   - float32: scalar FMA; a group of 4 (D <= 64) or 8 (D = 128) threads
//     shares one row and splits the head dimension, reducing each dot product
//     with shuffles.
//
// Bound at the ViT-B/16 training shape (B = 128, H = 12, N = 197, D = 64,
// bf16): one (B*H*N*D) bf16 tensor is 38.73 MB, LSE or delta 1.21 MB.
//   dQ:    reads q, k, v, dO, O, LSE, writes dQ, delta = 234.8 MB -> 70.1 us
//          at 3.35 TB/s; products 3 x 7.63 GFLOP -> 23.1 us at 989 TFLOP/s.
//   dK/dV: reads q, k, v, dO, LSE, delta, writes dK, dV = 234.8 MB -> 70.1 us;
//          products 4 x 7.63 GFLOP -> 30.9 us.
// Both are memory-bound (H100 SXM data sheet, 700 W).
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// element strides of one (B, H, N, D) operand; the last dim is contiguous
struct Strides {
  long long b, h, n;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;       // bf16 dQ only: O, from which it computes delta; or null
  const float* lse;    // (B*H, N), natural log, from the forward
  float* delta;        // (B*H, N), rowsum(dO * O): written by dQ given O, else read
  void* dq;
  void* dk;
  void* dv;
  int B, H, N;
  Strides q_st, k_st, v_st, do_st, o_st, dq_st, dk_st, dv_st;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e): P is recomputed in base 2
  int causal;
};

// Barrier over one head's threads only (ids 1..HPC; 0 is __syncthreads):
// the float32 kernels' heads share no shared memory.
__device__ __forceinline__ void head_barrier(int head, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(head + 1), "r"(nthreads) : "memory");
}

// offset of (batch, head) = divmod(bh, H) in an operand with strides st
__device__ __forceinline__ long long head_offset(const Params& p, int bh,
                                                 const Strides& st) {
  return (long long)(bh / p.H) * st.b + (long long)(bh % p.H) * st.h;
}

// two adjacent gradient values of one row, in the output dtype
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// ---------------------------------------------------------------- bf16 path

struct BwdMaps {  // TMA tensor maps of the q, k, v, dO and (dQ) O views
  CUtensorMap q, k, v, dout, o;
};

template <int D>
struct DqCfg {
  using T = hopper::Tile<D>;
  static constexpr int kBlock = 64;      // query rows; keys a K/V tile
  static constexpr int kStages = 2;      // K/V ring depth
  static constexpr int kQSlots = 2;      // this head's Q/dO, the next's
  static constexpr int kThreads = 160;   // consumer warpgroup + producer warp
  // CTAs an SM the registers must allow: 2 at D <= 64 (ptxas takes 146, no
  // spill; held to 3 CTAs' 128 it spilled, and ran no faster), 1 at
  // D = 128 (shared memory allows 3 and 1: 73 and 145 kB a CTA)
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  // Q and dO in each slot, one O tile, K and V in each stage
  static constexpr size_t kTileBytes =
      size_t(2 * kQSlots + 1 + 2 * kStages) * T::kBytes;
  static constexpr size_t kSmem =
      1024 + kTileBytes + 2 * (kQSlots + 1 + kStages) * sizeof(uint64_t);
};

// rowsum(dO o O) of row `row` of two tiles, over the 4 lanes (t = 0..3)
// that share the row. TMA's swizzle permutes the 16-byte chunks within each
// 32/64/128-byte panel row (the row is the swizzle's whole span) and does
// so alike in both tiles, so the row's products are summed where they lie.
template <int D>
__device__ __forceinline__ float tile_row_dot(const unsigned char* a,
                                              const unsigned char* b, int row,
                                              int t) {
  using T = hopper::Tile<D>;
  float acc = 0.f;
#pragma unroll
  for (int pn = 0; pn < T::kPanels; ++pn)
#pragma unroll
    for (int j = 0; j < T::kRowBytes / 16; ++j) {
      const int off = pn * T::kPanelBytes + row * T::kRowBytes + 4 * (4 * j + t);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + off));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + off));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

template <int D, int HPC, typename OutT>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, DqCfg<D>::kMinBlocks)
    bwd_dq_bf16_wgmma(const __grid_constant__ BwdMaps maps, const Params p) {
  using Cfg = DqCfg<D>;
  using T = hopper::Tile<D>;
  constexpr int BM = Cfg::kBlock, NS = Cfg::kStages, NQ = Cfg::kQSlots;
  extern __shared__ __align__(128) unsigned char smem_tma[];
  const uint32_t raw = hopper::smem_addr(smem_tma);
  unsigned char* base = smem_tma + ((1024 - (raw & 1023)) & 1023);
  unsigned char* q_s = base;                         // NQ tiles
  unsigned char* do_s = q_s + NQ * T::kBytes;        // NQ tiles
  unsigned char* o_s = do_s + NQ * T::kBytes;        // 1 tile
  unsigned char* k_s = o_s + T::kBytes;              // NS tiles
  unsigned char* v_s = k_s + NS * T::kBytes;         // NS tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + Cfg::kTileBytes);
  uint64_t* q_empty = q_full + NQ;
  uint64_t* o_full = q_empty + NQ;
  uint64_t* o_empty = o_full + 1;
  uint64_t* kv_full = o_empty + 1;
  uint64_t* kv_empty = kv_full + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NQ; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 128);
    }
    hopper::mbar_init(o_full, 1);
    hopper::mbar_init(o_empty, 128);
    for (int i = 0; i < NS; ++i) {
      hopper::mbar_init(&kv_full[i], 1);
      hopper::mbar_init(&kv_empty[i], 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const hopper::GridTile cta = hopper::grid_tile();
  const int q_block = cta.row * BM;
  // causal: keys past the block's last row never contribute
  const int n_kv = p.causal ? min(p.N, q_block + BM) : p.N;
  const int n_tiles = (n_kv + BM - 1) / BM;
  const bool fold = p.o != nullptr;  // delta from O here, else read

  if (warp == 4) {  // ---- producer: one thread keeps the copies in flight
    if (lane == 0) {
      hopper::tma_prefetch(&maps.q);
      hopper::tma_prefetch(&maps.k);
      hopper::tma_prefetch(&maps.v);
      hopper::tma_prefetch(&maps.dout);
      if (fold) hopper::tma_prefetch(&maps.o);
      hopper::Ring qr, orr, kr;
      for (int hh = 0; hh < HPC; ++hh) {
        const int bh = cta.group * HPC + hh, b = bh / p.H, h = bh % p.H;
        hopper::mbar_wait(&q_empty[qr.slot], qr.phase ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full[qr.slot], 2 * T::kBytes);
        hopper::tma_load_tile<D>(q_s + qr.slot * T::kBytes, &maps.q,
                                 &q_full[qr.slot], q_block, h, b);
        hopper::tma_load_tile<D>(do_s + qr.slot * T::kBytes, &maps.dout,
                                 &q_full[qr.slot], q_block, h, b);
        qr.advance(NQ);
        if (fold) {
          hopper::mbar_wait(o_empty, orr.phase ^ 1);
          hopper::mbar_arrive_expect_tx(o_full, T::kBytes);
          hopper::tma_load_tile<D>(o_s, &maps.o, o_full, q_block, h, b);
          orr.advance(1);
        }
        for (int tile = 0; tile < n_tiles; ++tile) {
          hopper::mbar_wait(&kv_empty[kr.slot], kr.phase ^ 1);
          hopper::mbar_arrive_expect_tx(&kv_full[kr.slot], 2 * T::kBytes);
          hopper::tma_load_tile<D>(k_s + kr.slot * T::kBytes, &maps.k,
                                   &kv_full[kr.slot], tile * BM, h, b);
          hopper::tma_load_tile<D>(v_s + kr.slot * T::kBytes, &maps.v,
                                   &kv_full[kr.slot], tile * BM, h, b);
          kr.advance(NS);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns query rows 16w .. 16w + 15
  const int g = lane >> 2, t = lane & 3;
  const int r_a = warp * 16 + g, r_b = r_a + 8;   // rows within the tile
  const int row_a = q_block + r_a, row_b = q_block + r_b;
  hopper::Ring qr, orr, kr;
  for (int hh = 0; hh < HPC; ++hh) {
    const int bh = cta.group * HPC + hh;
    hopper::mbar_wait(&q_full[qr.slot], qr.phase);
    const uint32_t q_tile = hopper::smem_addr(q_s + qr.slot * T::kBytes);
    const uint32_t do_tile = hopper::smem_addr(do_s + qr.slot * T::kBytes);

    const float* lse = p.lse + (long long)bh * p.N;
    float* delta = p.delta + (long long)bh * p.N;
    const float lse2[2] = {row_a < p.N ? lse[row_a] * kLog2e : 0.f,
                           row_b < p.N ? lse[row_b] * kLog2e : 0.f};
    float dlt[2];
    if (fold) {  // rows past N are zeros in both tiles: delta 0, not stored
      hopper::mbar_wait(o_full, orr.phase);
      const unsigned char* dw = do_s + qr.slot * T::kBytes;
      dlt[0] = tile_row_dot<D>(dw, o_s, r_a, t);
      dlt[1] = tile_row_dot<D>(dw, o_s, r_b, t);
      hopper::mbar_arrive(o_empty);
      orr.advance(1);
      if (t == 0) {
        if (row_a < p.N) delta[row_a] = dlt[0];
        if (row_b < p.N) delta[row_b] = dlt[1];
      }
    } else {
      dlt[0] = row_a < p.N ? delta[row_a] : 0.f;
      dlt[1] = row_b < p.N ? delta[row_b] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int kv0 = tile * BM;
      hopper::mbar_wait(&kv_full[kr.slot], kr.phase);
      const uint32_t k_tile = hopper::smem_addr(k_s + kr.slot * T::kBytes);
      const uint32_t v_tile = hopper::smem_addr(v_s + kr.slot * T::kBytes);

      // S = Q K^T and dP = dO V^T (64 queries x 64 keys each)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      hopper::wgmma_abt<D>(s, q_tile, k_tile);
      hopper::wgmma_abt<D>(dp, do_tile, v_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      if (tile == n_tiles - 1) hopper::mbar_arrive(&q_empty[qr.slot]);

      // element 4 nb + e sits at row (e < 2 ? row_a : row_b), key
      // kv0 + 8 nb + 2t + (e & 1); s becomes dS there (0 for masked keys)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nb * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool keep = col < p.N && (!p.causal || col <= row);
          const int i = 4 * nb + e;
          const float pr =
              keep ? exp2f(s[i] * p.scale_log2 - lse2[e >> 1]) : 0.f;
          s[i] = pr * (dp[i] - dlt[e >> 1]) * p.scale;
        }

      // dQ += dS K: dS from registers, K through the transpose mode
      uint32_t da[4][4];
      hopper::pack_a(s, da);
      hopper::fence_regs(dq);
      hopper::wgmma_fence();
      hopper::wgmma_xb<D>(dq, da, k_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dq);
      hopper::fence_a(da);
      hopper::mbar_arrive(&kv_empty[kr.slot]);
      kr.advance(NS);
    }
    qr.advance(NQ);

    OutT* dqg = static_cast<OutT*>(p.dq) + head_offset(p, bh, p.dq_st);
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      const int col = db * 8 + 2 * t;
      if (row_a < p.N)
        store2(dqg + (long long)row_a * p.dq_st.n + col, dq[4 * db], dq[4 * db + 1]);
      if (row_b < p.N)
        store2(dqg + (long long)row_b * p.dq_st.n + col, dq[4 * db + 2], dq[4 * db + 3]);
    }
  }
}

template <int D>
struct DkvCfg {
  using T = hopper::Tile<D>;
  static constexpr int kBlock = 64;                 // key rows; queries a tile
  static constexpr int kStages = 2;                 // Q/dO/LSE/delta ring depth
  static constexpr int kKvSlots = 2;                // this head's K/V, the next's
  static constexpr int kThreads = 160;              // consumer warpgroup + producer warp
  static constexpr size_t kTileBytes =
      size_t(2 * kKvSlots + 2 * kStages) * T::kBytes;
  static constexpr size_t kStatBytes = size_t(2 * kStages) * kBlock * sizeof(float);
  static constexpr size_t kSmem = 1024 + kTileBytes + kStatBytes +
                                  2 * (kKvSlots + kStages) * sizeof(uint64_t);
};

template <int D, int HPC, typename OutT>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads)
    bwd_dkv_bf16_wgmma(const __grid_constant__ BwdMaps maps, const Params p) {
  using Cfg = DkvCfg<D>;
  using T = hopper::Tile<D>;
  constexpr int BN = Cfg::kBlock, NS = Cfg::kStages, NK = Cfg::kKvSlots;
  extern __shared__ __align__(128) unsigned char smem_tma[];
  const uint32_t raw = hopper::smem_addr(smem_tma);
  unsigned char* base = smem_tma + ((1024 - (raw & 1023)) & 1023);
  unsigned char* k_s = base;                         // NK tiles
  unsigned char* v_s = k_s + NK * T::kBytes;         // NK tiles
  unsigned char* q_s = v_s + NK * T::kBytes;         // NS tiles
  unsigned char* do_s = q_s + NS * T::kBytes;        // NS tiles
  float* lse_s = reinterpret_cast<float*>(base + Cfg::kTileBytes);  // NS x 64
  float* dl_s = lse_s + NS * BN;                                     // NS x 64
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + NS * BN);
  uint64_t* kv_empty = kv_full + NK;
  uint64_t* rg_full = kv_empty + NK;
  uint64_t* rg_empty = rg_full + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NK; ++i) {
      hopper::mbar_init(&kv_full[i], 1);
      hopper::mbar_init(&kv_empty[i], 128);
    }
    for (int i = 0; i < NS; ++i) {
      hopper::mbar_init(&rg_full[i], 33);  // the copies' arrival + 32 lanes
      hopper::mbar_init(&rg_empty[i], 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const hopper::GridTile cta = hopper::grid_tile();
  const int k_block = cta.row * BN;
  // causal: query tiles before the block's first key never see it
  const int q_start = p.causal ? k_block : 0;

  if (warp == 4) {  // ---- producer warp: lane 0 copies tiles, all load stats
    if (lane == 0) {
      hopper::tma_prefetch(&maps.q);
      hopper::tma_prefetch(&maps.k);
      hopper::tma_prefetch(&maps.v);
      hopper::tma_prefetch(&maps.dout);
    }
    hopper::Ring kr, rr;
    for (int hh = 0; hh < HPC; ++hh) {
      const int bh = cta.group * HPC + hh, b = bh / p.H, h = bh % p.H;
      if (lane == 0) {
        hopper::mbar_wait(&kv_empty[kr.slot], kr.phase ^ 1);
        hopper::mbar_arrive_expect_tx(&kv_full[kr.slot], 2 * T::kBytes);
        hopper::tma_load_tile<D>(k_s + kr.slot * T::kBytes, &maps.k,
                                 &kv_full[kr.slot], k_block, h, b);
        hopper::tma_load_tile<D>(v_s + kr.slot * T::kBytes, &maps.v,
                                 &kv_full[kr.slot], k_block, h, b);
      }
      kr.advance(NK);
      const float* lse = p.lse + (long long)bh * p.N;
      const float* delta = p.delta + (long long)bh * p.N;
      for (int q0 = q_start; q0 < p.N; q0 += BN) {
        hopper::mbar_wait(&rg_empty[rr.slot], rr.phase ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&rg_full[rr.slot], 2 * T::kBytes);
          hopper::tma_load_tile<D>(q_s + rr.slot * T::kBytes, &maps.q,
                                   &rg_full[rr.slot], q0, h, b);
          hopper::tma_load_tile<D>(do_s + rr.slot * T::kBytes, &maps.dout,
                                   &rg_full[rr.slot], q0, h, b);
        }
        for (int i = lane; i < BN; i += 32) {
          const bool in = q0 + i < p.N;  // no LSE or delta read past N
          lse_s[rr.slot * BN + i] = in ? lse[q0 + i] * kLog2e : 0.f;
          dl_s[rr.slot * BN + i] = in ? delta[q0 + i] : 0.f;
        }
        hopper::mbar_arrive(&rg_full[rr.slot]);
        rr.advance(NS);
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns key rows 16w .. 16w + 15
  const int g = lane >> 2, t = lane & 3;
  const int key_a = k_block + warp * 16 + g, key_b = key_a + 8;
  hopper::Ring kr, rr;
  for (int hh = 0; hh < HPC; ++hh) {
    const int bh = cta.group * HPC + hh;
    hopper::mbar_wait(&kv_full[kr.slot], kr.phase);
    const uint32_t k_tile = hopper::smem_addr(k_s + kr.slot * T::kBytes);
    const uint32_t v_tile = hopper::smem_addr(v_s + kr.slot * T::kBytes);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int q0 = q_start; q0 < p.N; q0 += BN) {
      hopper::mbar_wait(&rg_full[rr.slot], rr.phase);
      const uint32_t q_tile = hopper::smem_addr(q_s + rr.slot * T::kBytes);
      const uint32_t do_tile = hopper::smem_addr(do_s + rr.slot * T::kBytes);
      const float* lw = lse_s + rr.slot * BN;
      const float* dw = dl_s + rr.slot * BN;

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries each)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      hopper::wgmma_abt<D>(s, k_tile, q_tile);
      hopper::wgmma_abt<D>(dp, v_tile, do_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // element 4 nb + e sits at key (e < 2 ? key_a : key_b), query
      // q0 + 8 nb + 2t + (e & 1); s becomes P^T and dp becomes dS^T there.
      // Query columns >= N get P = 0: they add nothing to dK or dV.
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nb * 8 + 2 * t + (e & 1);
          const int col = q0 + cl;
          const int key = e < 2 ? key_a : key_b;
          const bool keep = col < p.N && (!p.causal || key <= col);
          const int i = 4 * nb + e;
          const float pr = keep ? exp2f(s[i] * p.scale_log2 - lw[cl]) : 0.f;
          s[i] = pr;
          dp[i] = pr * (dp[i] - dw[cl]) * p.scale;
        }

      // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q through
      // the transpose mode
      uint32_t pa[4][4], da[4][4];
      hopper::pack_a(s, pa);
      hopper::pack_a(dp, da);
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::wgmma_fence();
      hopper::wgmma_xb<D>(dv, pa, do_tile);
      hopper::wgmma_xb<D>(dk, da, q_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::fence_a(pa);
      hopper::fence_a(da);
      hopper::mbar_arrive(&rg_empty[rr.slot]);
      rr.advance(NS);
    }
    hopper::mbar_arrive(&kv_empty[kr.slot]);
    kr.advance(NK);

    OutT* dkg = static_cast<OutT*>(p.dk) + head_offset(p, bh, p.dk_st);
    OutT* dvg = static_cast<OutT*>(p.dv) + head_offset(p, bh, p.dv_st);
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      const int col = db * 8 + 2 * t;
      if (key_a < p.N) {
        store2(dkg + (long long)key_a * p.dk_st.n + col, dk[4 * db], dk[4 * db + 1]);
        store2(dvg + (long long)key_a * p.dv_st.n + col, dv[4 * db], dv[4 * db + 1]);
      }
      if (key_b < p.N) {
        store2(dkg + (long long)key_b * p.dk_st.n + col, dk[4 * db + 2], dk[4 * db + 3]);
        store2(dvg + (long long)key_b * p.dv_st.n + col, dv[4 * db + 2], dv[4 * db + 3]);
      }
    }
  }
}

// ------------------------------------------------------------- float32 path

template <int D, int HPC>
struct SimtCfg {
  static constexpr int kTPR = D <= 64 ? 4 : 8;  // threads sharing one row
  static constexpr int kPer = D / kTPR;         // head dims per thread
  static constexpr int kHeadThreads = 128;
  static constexpr int kRows = kHeadThreads / kTPR;  // rows a head owns
  static constexpr int kTile = 32;  // rows of the other operand per tile
  static constexpr int kThreads = kHeadThreads * HPC;
  static constexpr size_t kSmem = size_t(HPC) * 2 * kTile * D * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long sn, int row0, int rows,
                                              int n, int tid, int nthreads) {
  constexpr int kVec = 4;  // 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = tid; i < rows * kPerRow; i += nthreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * sn + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = val;
  }
}

// sum over the TPR adjacent lanes that share a row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < TPR; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int D, int HPC>
__global__ void __launch_bounds__(SimtCfg<D, HPC>::kThreads)
    bwd_dq_f32_simt(const Params p) {
  using Cfg = SimtCfg<D, HPC>;
  constexpr int T = Cfg::kTile, TPR = Cfg::kTPR, PER = Cfg::kPer;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // HPC x T x D
  float* v_s = k_s + HPC * T * D;

  const int tid = threadIdx.x;
  const int hh = tid / Cfg::kHeadThreads;
  const int htid = tid % Cfg::kHeadThreads;
  const int part = htid % TPR;  // this thread owns dims part + TPR * i
  const hopper::GridTile cta = hopper::grid_tile();
  const int q_block = cta.row * Cfg::kRows;
  const int row = q_block + htid / TPR;
  const int bh = cta.group * HPC + hh;

  const float* kg = static_cast<const float*>(p.k) + head_offset(p, bh, p.k_st);
  const float* vg = static_cast<const float*>(p.v) + head_offset(p, bh, p.v_st);
  const float* qrow = static_cast<const float*>(p.q) +
                      head_offset(p, bh, p.q_st) + (long long)row * p.q_st.n;
  const float* dorow = static_cast<const float*>(p.dout) +
                       head_offset(p, bh, p.do_st) + (long long)row * p.do_st.n;
  const bool in = row < p.N;
  float q[PER], dout[PER], dq[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    q[i] = in ? qrow[part + TPR * i] : 0.f;
    dout[i] = in ? dorow[part + TPR * i] : 0.f;
    dq[i] = 0.f;
  }
  const float lse2 = in ? p.lse[(long long)bh * p.N + row] * kLog2e : 0.f;
  const float dlt = in ? p.delta[(long long)bh * p.N + row] : 0.f;
  const int n_kv = p.causal ? min(p.N, q_block + Cfg::kRows) : p.N;
  const float* kw = k_s + hh * T * D;
  const float* vw = v_s + hh * T * D;

  for (int kv0 = 0; kv0 < n_kv; kv0 += T) {
    head_barrier(hh, Cfg::kHeadThreads);
    load_rows_f32<D>(k_s + hh * T * D, kg, p.k_st.n, kv0, T, p.N, htid,
                     Cfg::kHeadThreads);
    load_rows_f32<D>(v_s + hh * T * D, vg, p.v_st.n, kv0, T, p.N, htid,
                     Cfg::kHeadThreads);
    head_barrier(hh, Cfg::kHeadThreads);
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s = fmaf(q[i], kw[j * D + part + TPR * i], s);
        dp = fmaf(dout[i], vw[j * D + part + TPR * i], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int col = kv0 + j;
      const bool keep = col < p.N && (!p.causal || col <= row);
      const float pr = keep ? exp2f(s * p.scale_log2 - lse2) : 0.f;
      const float ds = pr * (dp - dlt) * p.scale;
#pragma unroll
      for (int i = 0; i < PER; ++i) dq[i] = fmaf(ds, kw[j * D + part + TPR * i], dq[i]);
    }
  }
  if (in) {
    float* out = static_cast<float*>(p.dq) + head_offset(p, bh, p.dq_st) +
                 (long long)row * p.dq_st.n;
#pragma unroll
    for (int i = 0; i < PER; ++i) out[part + TPR * i] = dq[i];
  }
}

template <int D, int HPC>
__global__ void __launch_bounds__(SimtCfg<D, HPC>::kThreads)
    bwd_dkv_f32_simt(const Params p) {
  using Cfg = SimtCfg<D, HPC>;
  constexpr int T = Cfg::kTile, TPR = Cfg::kTPR, PER = Cfg::kPer;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // HPC x T x D
  float* do_s = q_s + HPC * T * D;                  // HPC x T x D
  float* lse_s = do_s + HPC * T * D;                // HPC x T
  float* dl_s = lse_s + HPC * T;                    // HPC x T

  const int tid = threadIdx.x;
  const int hh = tid / Cfg::kHeadThreads;
  const int htid = tid % Cfg::kHeadThreads;
  const int part = htid % TPR;
  const hopper::GridTile cta = hopper::grid_tile();
  const int k_block = cta.row * Cfg::kRows;
  const int key = k_block + htid / TPR;
  const int bh = cta.group * HPC + hh;

  const float* qg = static_cast<const float*>(p.q) + head_offset(p, bh, p.q_st);
  const float* dog = static_cast<const float*>(p.dout) + head_offset(p, bh, p.do_st);
  const float* krow = static_cast<const float*>(p.k) +
                      head_offset(p, bh, p.k_st) + (long long)key * p.k_st.n;
  const float* vrow = static_cast<const float*>(p.v) +
                      head_offset(p, bh, p.v_st) + (long long)key * p.v_st.n;
  const float* lse = p.lse + (long long)bh * p.N;
  const float* delta = p.delta + (long long)bh * p.N;
  const bool in = key < p.N;
  float k[PER], v[PER], dk[PER], dv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    k[i] = in ? krow[part + TPR * i] : 0.f;
    v[i] = in ? vrow[part + TPR * i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  const float* qw = q_s + hh * T * D;
  const float* dw = do_s + hh * T * D;
  const float* lw = lse_s + hh * T;
  const float* lw_delta = dl_s + hh * T;

  const int q_start = p.causal ? (k_block / T) * T : 0;
  for (int q0 = q_start; q0 < p.N; q0 += T) {
    head_barrier(hh, Cfg::kHeadThreads);
    load_rows_f32<D>(q_s + hh * T * D, qg, p.q_st.n, q0, T, p.N, htid,
                     Cfg::kHeadThreads);
    load_rows_f32<D>(do_s + hh * T * D, dog, p.do_st.n, q0, T, p.N, htid,
                     Cfg::kHeadThreads);
    for (int i = htid; i < T; i += Cfg::kHeadThreads) {
      const bool qin = q0 + i < p.N;
      lse_s[hh * T + i] = qin ? lse[q0 + i] * kLog2e : 0.f;
      dl_s[hh * T + i] = qin ? delta[q0 + i] : 0.f;
    }
    head_barrier(hh, Cfg::kHeadThreads);
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s = fmaf(k[i], qw[j * D + part + TPR * i], s);
        dp = fmaf(v[i], dw[j * D + part + TPR * i], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int col = q0 + j;
      const bool keep = col < p.N && (!p.causal || key <= col);
      const float pr = keep ? exp2f(s * p.scale_log2 - lw[j]) : 0.f;
      const float ds = pr * (dp - lw_delta[j]) * p.scale;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        dv[i] = fmaf(pr, dw[j * D + part + TPR * i], dv[i]);
        dk[i] = fmaf(ds, qw[j * D + part + TPR * i], dk[i]);
      }
    }
  }
  if (in) {
    float* dkrow = static_cast<float*>(p.dk) + head_offset(p, bh, p.dk_st) +
                   (long long)key * p.dk_st.n;
    float* dvrow = static_cast<float*>(p.dv) + head_offset(p, bh, p.dv_st) +
                   (long long)key * p.dv_st.n;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      dkrow[part + TPR * i] = dk[i];
      dvrow[part + TPR * i] = dv[i];
    }
  }
}

// ----------------------------------------------------------------- dispatch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor maps of the first `count` of q, k, v, dO, O.
template <int D>
cudaError_t encode_maps(const Params& p, int count, BwdMaps* maps) {
  const void* src[5] = {p.q, p.k, p.v, p.dout, p.o};
  const Strides st[5] = {p.q_st, p.k_st, p.v_st, p.do_st, p.o_st};
  CUtensorMap* dst[5] = {&maps->q, &maps->k, &maps->v, &maps->dout, &maps->o};
  const cudaError_t bound = hopper::bind_context();
  if (bound != cudaSuccess) return bound;
  for (int i = 0; i < count; ++i) {
    const cudaError_t err = hopper::encode_bhnd(dst[i], src[i], p.B, p.H, p.N, D,
                                                st[i].b, st[i].h, st[i].n);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D, int HPC, typename OutT>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t s) {
  using C = DqCfg<D>;
  BwdMaps maps = {};
  cudaError_t err = encode_maps<D>(p, p.o ? 5 : 4, &maps);
  if (err != cudaSuccess) return err;
  err = hopper::allow_smem<bwd_dq_bf16_wgmma<D, HPC, OutT>>(C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H / HPC, (p.N + C::kBlock - 1) / C::kBlock);
  bwd_dq_bf16_wgmma<D, HPC, OutT><<<grid, C::kThreads, C::kSmem, s>>>(maps, p);
  return cudaGetLastError();
}

template <int D, int HPC>
cudaError_t run_dq(const Params& p, int bf16_in, int bf16_out, cudaStream_t s) {
  if (bf16_in)
    return bf16_out ? launch_dq_wgmma<D, HPC, bf16>(p, s)
                    : launch_dq_wgmma<D, HPC, float>(p, s);
  if (bf16_out || p.o) return cudaErrorInvalidValue;  // float32 reads delta
  using C = SimtCfg<D, HPC>;
  const dim3 grid(p.B * p.H / HPC, (p.N + C::kRows - 1) / C::kRows);
  return launch(bwd_dq_f32_simt<D, HPC>, grid, C::kThreads, C::kSmem, s, p);
}

template <int D, int HPC, typename OutT>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t s) {
  using C = DkvCfg<D>;
  BwdMaps maps = {};
  cudaError_t err = encode_maps<D>(p, 4, &maps);
  if (err != cudaSuccess) return err;
  err = hopper::allow_smem<bwd_dkv_bf16_wgmma<D, HPC, OutT>>(C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H / HPC, (p.N + C::kBlock - 1) / C::kBlock);
  bwd_dkv_bf16_wgmma<D, HPC, OutT><<<grid, C::kThreads, C::kSmem, s>>>(maps, p);
  return cudaGetLastError();
}

template <int D, int HPC>
cudaError_t run_dkv(const Params& p, int bf16_in, int bf16_out, cudaStream_t s) {
  if (bf16_in)
    return bf16_out ? launch_dkv_wgmma<D, HPC, bf16>(p, s)
                    : launch_dkv_wgmma<D, HPC, float>(p, s);
  if (bf16_out) return cudaErrorInvalidValue;
  using C = SimtCfg<D, HPC>;
  const dim3 grid(p.B * p.H / HPC, (p.N + C::kRows - 1) / C::kRows);
  return launch(bwd_dkv_f32_simt<D, HPC>, grid, C::kThreads,
                C::kSmem + size_t(HPC) * 2 * C::kTile * sizeof(float), s, p);
}

template <int HPC>
cudaError_t run_hpc(const Params& p, int d, int which, int bf16_in,
                    int bf16_out, cudaStream_t s) {
  switch (d) {
    case 16: return which ? run_dkv<16, HPC>(p, bf16_in, bf16_out, s) : run_dq<16, HPC>(p, bf16_in, bf16_out, s);
    case 32: return which ? run_dkv<32, HPC>(p, bf16_in, bf16_out, s) : run_dq<32, HPC>(p, bf16_in, bf16_out, s);
    case 64: return which ? run_dkv<64, HPC>(p, bf16_in, bf16_out, s) : run_dq<64, HPC>(p, bf16_in, bf16_out, s);
    case 128: return which ? run_dkv<128, HPC>(p, bf16_in, bf16_out, s) : run_dq<128, HPC>(p, bf16_in, bf16_out, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int d, int which, int heads_per_cta, int dtype,
        int out_dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != 1) return cudaErrorInvalidValue;
  if (p.B < 1 || p.H < 1 || p.N < 1 || heads_per_cta < 1 || p.H % heads_per_cta)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads_per_cta) {
    case 1: return run_hpc<1>(p, d, which, dtype, out_dtype, s);
    case 2: return run_hpc<2>(p, d, which, dtype, out_dtype, s);
    case 4: return run_hpc<4>(p, d, which, dtype, out_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

Strides strides_at(const long long* src) { return Strides{src[0], src[1], src[2]}; }

}  // namespace

extern "C" {

// q, k, v, dout, o, dq: (B, H, N, D) with element strides (batch, head,
// row) and a contiguous last dim; every pointer 16-byte aligned and every
// stride a multiple of 16 bytes (the Python wrapper checks). lse, delta:
// (B*H, N) float32, contiguous. o: bf16 inputs only, or null: given O, the
// kernel computes delta = rowsum(dO * O) and writes it to `delta` (for the
// dK/dV kernel); given null, it reads `delta`. strides: q, k, v, dout, o
// (ignored when null), dq, 3 each (18 values). dtype (inputs) and out_dtype
// (dq): 0 = float32, 1 = bfloat16; float32 inputs take float32 gradients
// only. heads_per_cta in {1, 2, 4} divides H. Returns cudaGetLastError()
// after the launch (0 on success).
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const void* lse,
                      void* delta, void* dq, int B, int H, int N, int D,
                      const long long* strides, float sm_scale, int causal,
                      int heads_per_cta, int dtype, int out_dtype,
                      void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.o = o;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.B = B; p.H = H; p.N = N;
  p.q_st = strides_at(strides + 0);
  p.k_st = strides_at(strides + 3);
  p.v_st = strides_at(strides + 6);
  p.do_st = strides_at(strides + 9);
  p.o_st = strides_at(strides + 12);
  p.dq_st = strides_at(strides + 15);
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  p.causal = causal;
  return run(p, D, 0, heads_per_cta, dtype, out_dtype, stream);
}

// As flash_attn_bwd_dq with no O (delta is read: launch dQ first), writing
// dk and dv (same dtype, out_dtype). strides: q, k, v, dout, dk, dv, 3 each
// (18 values).
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int N, int D,
                       const long long* strides, float sm_scale, int causal,
                       int heads_per_cta, int dtype, int out_dtype,
                       void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.N = N;
  p.q_st = strides_at(strides + 0);
  p.k_st = strides_at(strides + 3);
  p.v_st = strides_at(strides + 6);
  p.do_st = strides_at(strides + 9);
  p.dk_st = strides_at(strides + 12);
  p.dv_st = strides_at(strides + 15);
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  p.causal = causal;
  return run(p, D, 1, heads_per_cta, dtype, out_dtype, stream);
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
