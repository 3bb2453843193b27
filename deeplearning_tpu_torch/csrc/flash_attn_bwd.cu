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
// deterministic. LSE and delta are plain (B*H, N) float32 arrays; delta is
// computed outside the kernels, as the TPU code does.
//
// Design against the TPU original:
//   - The Pallas grid padded N to a block multiple (zero rows of dO made the
//     padded queries harmless). Here nothing is padded: the dQ kernel masks
//     key columns >= N, and the dK/dV kernel masks query columns >= N
//     (P = 0 there, and no LSE or delta row past N is ever read; Q and dO
//     rows past N arrive as zeros from the copy engine).
//   - dQ, bf16 (bwd_dq_bf16_mma): every product is mma.sync.m16n8k16 (bf16
//     in, f32 accumulate). Each warp owns 16 query rows; S and dP leave
//     their products in the accumulator layout, dS is formed in registers
//     and repacked as the A operand of dS K (as the forward repacks P).
//     Each head's warps synchronise on their own named barrier (ids
//     1..HPC): the heads of a CTA share no shared memory.
//   - dK/dV, bf16 (bwd_dkv_bf16_wgmma), built for Hopper like the forward
//     (helpers in hopper.cuh):
//       * 160 threads: one consumer warpgroup that owns the CTA's 64 key
//         rows (warp w keys 16w..16w+15) and one producer warp.
//       * The head's K and V tiles are TMA-loaded once into one of 2 slots
//         (the next head's arrive under this one's products) and read by
//         the tensor cores straight from shared memory: never reloaded.
//       * Q and dO tiles of 64 queries stream through a ring of 2 stages:
//         lane 0 of the producer warp issues their TMA loads, and the whole
//         warp stages the tile's LSE (times log2 e) and delta beside them;
//         a stage's "full" mbarrier waits for both (one arrival carrying
//         the copies' bytes, plus 32), its "empty" one for the consumers.
//       * S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both
//         operands in shared memory (K-major descriptors); P^T and dS^T
//         come out in the accumulator layout with keys as rows, are
//         rounded to bf16 in registers and are the A operands of
//         dV += P^T dO and dK += dS^T Q, wgmma m64nDk16 with dO and Q read
//         through the descriptor's transpose (MN-major) mode.
//       * The two 64 x D float32 accumulators stay in registers for the
//         whole query loop (2 x D/2 a thread; ptxas reports no spills at any
//         D, 229 registers at D = 128). Causal: the walk starts at the
//         query tile of the block's first key.
//       * Swizzle (128/64/32-byte), tiles on 1024-byte boundaries, tensor
//         maps and heads_per_cta (heads walked in sequence by one CTA, not
//         more threads) as in the forward.
//   - float32: scalar FMA; a group of 4 (D <= 64) or 8 (D = 128) threads
//     shares one row and splits the head dimension, reducing each dot product
//     with shuffles.
//
// Bound at the ViT-B/16 training shape (B = 128, H = 12, N = 197, D = 64,
// bf16): one (B*H*N*D) bf16 tensor is 38.73 MB, LSE or delta 1.21 MB.
//   dQ:    reads q, k, v, dO, LSE, delta, writes dQ  = 196.1 MB -> 58.5 us at
//          3.35 TB/s; products 3 x 7.63 GFLOP -> 23.1 us at 989 TFLOP/s.
//   dK/dV: reads the same, writes dK, dV            = 234.8 MB -> 70.1 us;
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
  const float* lse;    // (B*H, N), natural log, from the forward
  const float* delta;  // (B*H, N), rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int B, H, N;
  Strides q_st, k_st, v_st, do_st, dq_st, dk_st, dv_st;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e): P is recomputed in base 2
  int causal;
};

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

// rows [row0, row0 + rows) of one head into shared memory; rows >= n are
// zero, so a masked row contributes exactly 0 to every product.
template <int D, int STRIDE>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               long long sn, int row0,
                                               int rows, int n, int tid,
                                               int nthreads) {
  constexpr int kVec = 8;  // 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = tid; i < rows * kPerRow; i += nthreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sn + c);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[nb] (16 x 8 each) += A(16 x K) * B^T where A is the warp's 16-row
// strip `aw` and B is `rows` rows of `bw`, both row-major in shared memory
// with row stride S: the dQ kernel's products S = Q K^T and dP = dO V^T.
template <int K, int NB, int S>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const bf16* aw,
                                        const bf16* bw, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t a0 = ld32(aw + g * S + c);
    const uint32_t a1 = ld32(aw + (g + 8) * S + c);
    const uint32_t a2 = ld32(aw + g * S + c + 8);
    const uint32_t a3 = ld32(aw + (g + 8) * S + c + 8);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const bf16* br = bw + (nb * 8 + g) * S + c;
      mma_bf16(acc[nb], a0, a1, a2, a3, ld32(br), ld32(br + 8));
    }
  }
}

// out[db] (16 x 8 each, D / 8 of them) += X(16 x 16*KS) * B, where X sits in
// registers in the accumulator layout (x[nb], 8 columns each) and B is
// 16*KS rows of `bw` (row-major, stride S): dQ += dS K. Two adjacent
// 8-column blocks of X are one A operand.
template <int D, int KS, int S>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4],
                                       const float (&x)[2 * KS][4],
                                       const bf16* bw, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a0 = hopper::pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = hopper::pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = hopper::pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = hopper::pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const unsigned short* br =
        reinterpret_cast<const unsigned short*>(bw + (kk * 16 + 2 * t) * S);
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      const int col = db * 8 + g;
      const uint32_t b0 = uint32_t(br[col]) | (uint32_t(br[S + col]) << 16);
      const uint32_t b1 =
          uint32_t(br[8 * S + col]) | (uint32_t(br[9 * S + col]) << 16);
      mma_bf16(out[db], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int D, int HPC>
struct DqCfg {
  static constexpr int kWarpsPerHead = 4;
  static constexpr int kBlockM = 16 * kWarpsPerHead;  // query rows per head
  static constexpr int kBlockN = D <= 32 ? 64 : 32;   // keys per K/V tile
  static constexpr int kStride = D + 8;               // padded smem row
  static constexpr int kHeadThreads = 32 * kWarpsPerHead;
  static constexpr int kThreads = kHeadThreads * HPC;
  static constexpr size_t kSmem =
      size_t(HPC) * (2 * kBlockM + 2 * kBlockN) * kStride * sizeof(bf16);
};

template <int D, int HPC, typename OutT>
__global__ void __launch_bounds__(DqCfg<D, HPC>::kThreads)
    bwd_dq_bf16_mma(const Params p) {
  using Cfg = DqCfg<D, HPC>;
  constexpr int BM = Cfg::kBlockM, BN = Cfg::kBlockN, S = Cfg::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // HPC x BM x S
  bf16* do_s = q_s + HPC * BM * S;                // HPC x BM x S
  bf16* k_s = do_s + HPC * BM * S;                // HPC x BN x S
  bf16* v_s = k_s + HPC * BN * S;                 // HPC x BN x S

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hh = warp / Cfg::kWarpsPerHead;         // head within the CTA
  const int m0 = (warp % Cfg::kWarpsPerHead) * 16;  // warp's 16-row strip
  const int g = lane >> 2, t = lane & 3;            // mma fragment coords
  const int htid = tid % Cfg::kHeadThreads;
  const int q_block = blockIdx.x * BM;
  const int bh = blockIdx.y * HPC + hh;

  const bf16* qg = static_cast<const bf16*>(p.q) + head_offset(p, bh, p.q_st);
  const bf16* kg = static_cast<const bf16*>(p.k) + head_offset(p, bh, p.k_st);
  const bf16* vg = static_cast<const bf16*>(p.v) + head_offset(p, bh, p.v_st);
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + head_offset(p, bh, p.do_st);
  load_rows_bf16<D, S>(q_s + hh * BM * S, qg, p.q_st.n, q_block, BM, p.N, htid,
                       Cfg::kHeadThreads);
  load_rows_bf16<D, S>(do_s + hh * BM * S, dog, p.do_st.n, q_block, BM, p.N,
                       htid, Cfg::kHeadThreads);

  const int row_a = q_block + m0 + g, row_b = row_a + 8;
  const float* lse = p.lse + (long long)bh * p.N;
  const float* delta = p.delta + (long long)bh * p.N;
  const float lse2[2] = {row_a < p.N ? lse[row_a] * kLog2e : 0.f,
                         row_b < p.N ? lse[row_b] * kLog2e : 0.f};
  const float dlt[2] = {row_a < p.N ? delta[row_a] : 0.f,
                        row_b < p.N ? delta[row_b] : 0.f};

  // causal: keys past the block's last row never contribute
  const int n_kv = p.causal ? min(p.N, q_block + BM) : p.N;
  const int n_tiles = (n_kv + BN - 1) / BN;
  const bf16* qw = q_s + hh * BM * S + m0 * S;
  const bf16* dow = do_s + hh * BM * S + m0 * S;
  const bf16* kw = k_s + hh * BN * S;
  const bf16* vw = v_s + hh * BN * S;

  float dq[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[db][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BN;
    head_barrier(hh, Cfg::kHeadThreads);  // previous tile consumed, Q/dO stored
    load_rows_bf16<D, S>(k_s + hh * BN * S, kg, p.k_st.n, kv0, BN, p.N, htid,
                         Cfg::kHeadThreads);
    load_rows_bf16<D, S>(v_s + hh * BN * S, vg, p.v_st.n, kv0, BN, p.N, htid,
                         Cfg::kHeadThreads);
    head_barrier(hh, Cfg::kHeadThreads);

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_abt<D, BN / 8, S>(s, qw, kw, g, t);    // S  = Q K^T
    mma_abt<D, BN / 8, S>(dp, dow, vw, g, t);  // dP = dO V^T

    // element e of s[nb] sits at row (e < 2 ? row_a : row_b), key
    // kv0 + nb*8 + 2t + (e & 1); s[nb][e] becomes dS there
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nb * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool keep = col < p.N && (!p.causal || col <= row);
        const float pr = keep ? exp2f(s[nb][e] * p.scale_log2 - lse2[e >> 1]) : 0.f;
        s[nb][e] = pr * (dp[nb][e] - dlt[e >> 1]) * p.scale;
      }
    mma_xb<D, BN / 16, S>(dq, s, kw, g, t);  // dQ += dS K
  }

  OutT* dqg = static_cast<OutT*>(p.dq) + head_offset(p, bh, p.dq_st);
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int col = db * 8 + 2 * t;
    if (row_a < p.N) store2(dqg + (long long)row_a * p.dq_st.n + col, dq[db][0], dq[db][1]);
    if (row_b < p.N) store2(dqg + (long long)row_b * p.dq_st.n + col, dq[db][2], dq[db][3]);
  }
}

struct BwdMaps {  // TMA tensor maps of the q, k, v and dO views
  CUtensorMap q, k, v, dout;
};

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

  const int k_block = blockIdx.x * BN;
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
      const int bh = blockIdx.y * HPC + hh, b = bh / p.H, h = bh % p.H;
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
    const int bh = blockIdx.y * HPC + hh;
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
  const int q_block = blockIdx.x * Cfg::kRows;
  const int row = q_block + htid / TPR;
  const int bh = blockIdx.y * HPC + hh;

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
  const int k_block = blockIdx.x * Cfg::kRows;
  const int key = k_block + htid / TPR;
  const int bh = blockIdx.y * HPC + hh;

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

template <int D, int HPC>
cudaError_t run_dq(const Params& p, int bf16_in, int bf16_out, cudaStream_t s) {
  if (bf16_in) {
    using C = DqCfg<D, HPC>;
    const dim3 grid((p.N + C::kBlockM - 1) / C::kBlockM, p.B * p.H / HPC);
    if (bf16_out)
      return launch(bwd_dq_bf16_mma<D, HPC, bf16>, grid, C::kThreads, C::kSmem, s, p);
    return launch(bwd_dq_bf16_mma<D, HPC, float>, grid, C::kThreads, C::kSmem, s, p);
  }
  if (bf16_out) return cudaErrorInvalidValue;
  using C = SimtCfg<D, HPC>;
  const dim3 grid((p.N + C::kRows - 1) / C::kRows, p.B * p.H / HPC);
  return launch(bwd_dq_f32_simt<D, HPC>, grid, C::kThreads, C::kSmem, s, p);
}

template <int D, int HPC, typename OutT>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t s) {
  using C = DkvCfg<D>;
  BwdMaps maps;
  const void* src[4] = {p.q, p.k, p.v, p.dout};
  const Strides st[4] = {p.q_st, p.k_st, p.v_st, p.do_st};
  CUtensorMap* dst[4] = {&maps.q, &maps.k, &maps.v, &maps.dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = hopper::encode_bhnd(dst[i], src[i], p.B, p.H, p.N, D,
                                                st[i].b, st[i].h, st[i].n);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err =
      hopper::allow_smem<bwd_dkv_bf16_wgmma<D, HPC, OutT>>(C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + C::kBlock - 1) / C::kBlock, p.B * p.H / HPC);
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
  const dim3 grid((p.N + C::kRows - 1) / C::kRows, p.B * p.H / HPC);
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

// q, k, v, dout, dq: (B, H, N, D) with element strides (batch, head, row)
// and a contiguous last dim; every pointer 16-byte aligned and every stride
// a multiple of 16 bytes (the Python wrapper checks). lse, delta: (B*H, N)
// float32. strides: q, k, v, dout, dq, 3 each (15 values).
// dtype (inputs) and out_dtype (dq): 0 = float32, 1 = bfloat16; float32
// inputs take float32 gradients only. heads_per_cta in {1, 2, 4} divides H.
// Returns cudaGetLastError() after the launch (0 on success).
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int N, int D,
                      const long long* strides, float sm_scale, int causal,
                      int heads_per_cta, int dtype, int out_dtype,
                      void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.B = B; p.H = H; p.N = N;
  p.q_st = strides_at(strides + 0);
  p.k_st = strides_at(strides + 3);
  p.v_st = strides_at(strides + 6);
  p.do_st = strides_at(strides + 9);
  p.dq_st = strides_at(strides + 12);
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  p.causal = causal;
  return run(p, D, 0, heads_per_cta, dtype, out_dtype, stream);
}

// As flash_attn_bwd_dq, writing dk and dv (same dtype, out_dtype).
// strides: q, k, v, dout, dk, dv, 3 each (18 values).
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int N, int D,
                       const long long* strides, float sm_scale, int causal,
                       int heads_per_cta, int dtype, int out_dtype,
                       void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
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
