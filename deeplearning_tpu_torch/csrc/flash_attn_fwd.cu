// Flash-attention forward for Hopper (sm_90a): online-softmax attention that
// never writes the (N, N) score matrix to device memory.
//
// Replaces the TPU Pallas kernels in deeplearning_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel     (:38)  -- one head per program      -> HPC = 1
//   _fwd_kernel_hb  (:166) -- head_block heads a program -> HPC = 2 or 4
// One source, one template parameter (heads per CTA, "HPC") for both.
//
// What it computes, per (batch, head): S = Q K^T * sm_scale, keys at or past
// N masked (and keys past the query row when causal), O = softmax(S) V, and
// the row log-sum-exp LSE = log(sum(exp(S))). O is written in the input
// dtype with arbitrary row/head/batch strides (last dim contiguous), so the
// ViT adapter passes views of the fused qkv and of a (B, N, H, D) output
// without transposes. LSE is a plain (B*H, N) float32 array.
//
// Design against the TPU original:
//   - The Pallas grid walked K/V blocks sequentially on one core with N
//     padded to a power-of-two block multiple (_blocks_and_pad). Here the
//     grid is (B*H / HPC, query tiles), the head groups on grid.x so no
//     batch overflows the grid (hopper::grid_tile); a loop inside the CTA
//     walks the K/V tiles and the ragged edge (rows or keys >= N) is
//     masked in the kernel, so no padded copy of q/k/v is ever made. D is
//     16, 32, 64 or 128 here; the Python wrapper zero-pads any other
//     D <= 128 up to the next of them (exact: zero columns add nothing to
//     Q K^T, and the padded output columns are dropped).
//   - The running max m, the running sum l and the O accumulator stay in
//     float32 registers for the whole loop; only O and LSE are written.
//   - bf16 (fwd_bf16_wgmma), built for Hopper (helpers in hopper.cuh):
//       * 160 threads: one consumer warpgroup that owns the CTA's 64 query
//         rows (warp w rows 16w..16w+15), and one producer warp whose lane 0
//         issues every copy. They meet only on mbarriers.
//       * Copies are TMA loads of 64-row boxes through rank-4 tensor maps
//         of the strided (B, H, N, D) views (encoded on the host per call),
//         completing on "full" mbarriers. Rows past N arrive as zeros from
//         the copy engine: nothing is padded in device memory.
//       * A ring of 2 K/V stages ("empty" mbarriers hand a stage back once
//         both products that read it are done), so the loads of key tile
//         j+1 run under the products of tile j; Q is loaded once per head
//         into one of 2 slots, so the next head's Q arrives early too.
//       * S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//         (K-major descriptors); O += P V is wgmma m64nDk16 with P as the
//         register A operand (the S accumulator, rounded to bf16, is
//         already in the A layout) and V read through the descriptor's
//         transpose (MN-major) mode: no per-element shared-memory gathers.
//       * Shared tiles use the TMA swizzle the descriptors name: 128-byte
//         for D >= 64 (D = 128 is two 64-column panels), 64-byte for D =
//         32, 32-byte for D = 16; every tile sits on a 1024-byte boundary.
//       * heads_per_cta (the JAX head_block) is how many heads a CTA walks
//         in sequence through the same ring; it no longer multiplies the
//         threads, so every instantiation has the same shape and the
//         registers of one warpgroup (ptxas reports no spills).
//       * Key tiles are 64 keys; at N = 197 that is 4 tiles, the last 5
//         keys wide (masked in registers), the same padded work as 2 tiles
//         of 128 with half the S registers.
//   - float32: scalar FMA (no tensor cores); four threads share a query row
//     and split the head dimension, reducing each score with two shuffles.
//
// Bound at ViT-B/16 (N = 197, H = 12, D = 64, bf16), one launch per layer at
// batch b: q, k, v and O are b*12*197*64*2 bytes each, LSE b*12*197*4 bytes,
// about 1.22 MB an image; the two products are 4*b*12*197^2*64, about 119
// MFLOP an image. That is ~98 FLOP/byte, under the H100's ~295 FLOP/byte
// ridge, so the kernel is memory-bound: at b = 32 about 11.7 us of HBM time
// against about 3.9 us of tensor-core time, at b = 128 46.6 us against 15.4
// (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16 dense, 700 W). The
// naive path, by contrast, writes and re-reads the b*12*197*197 score and
// probability tensors.
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; flash_attn_fwd returns cudaGetLastError() (or
// the error of encoding a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // same finite mask value as the TPU kernel
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, N;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale_log2;  // sm_scale * log2(e): the softmax runs in base 2
  int causal;
};

// Barrier over one head's threads only (ids 1..HPC; 0 is __syncthreads):
// the heads of a CTA share no shared memory, so each group loads its own
// tiles and runs at its own pace, and one head's loads overlap another's
// products instead of the whole CTA stalling on every tile.
__device__ __forceinline__ void head_barrier(int head, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(head + 1), "r"(nthreads) : "memory");
}

__device__ __forceinline__ long long head_offset(const Params& p, int bh,
                                                 long long sb, long long sh) {
  return (long long)(bh / p.H) * sb + (long long)(bh % p.H) * sh;
}

// ---------------------------------------------------------------- bf16 path

struct FwdMaps {  // TMA tensor maps of the q, k and v views
  CUtensorMap q, k, v;
};

template <int D>
struct WgmmaCfg {
  using T = hopper::Tile<D>;
  static constexpr int kBlock = 64;                 // query rows, keys a tile
  static constexpr int kStages = 2;                 // K/V ring depth
  static constexpr int kQSlots = 2;                 // this head's Q, the next's
  static constexpr int kThreads = 160;              // consumer warpgroup + producer warp
  // CTAs an SM the registers must allow: 4 at D <= 64 (<= 102 a thread;
  // shared memory allows 4 too), 2 at D = 128
  static constexpr int kMinBlocks = D <= 64 ? 4 : 2;
  static constexpr size_t kTileBytes =
      size_t(kQSlots + 2 * kStages) * T::kBytes;
  static constexpr size_t kSmem =
      1024 + kTileBytes + 2 * (kQSlots + kStages) * sizeof(uint64_t);
};

template <int D, int HPC>
__global__ void __launch_bounds__(WgmmaCfg<D>::kThreads, WgmmaCfg<D>::kMinBlocks)
    fwd_bf16_wgmma(const __grid_constant__ FwdMaps maps, const Params p) {
  using Cfg = WgmmaCfg<D>;
  using T = hopper::Tile<D>;
  constexpr int BM = Cfg::kBlock, NS = Cfg::kStages, NQ = Cfg::kQSlots;
  extern __shared__ __align__(128) unsigned char smem_tma[];
  const uint32_t raw = hopper::smem_addr(smem_tma);
  unsigned char* base = smem_tma + ((1024 - (raw & 1023)) & 1023);
  unsigned char* q_s = base;                         // NQ tiles
  unsigned char* k_s = q_s + NQ * T::kBytes;         // NS tiles
  unsigned char* v_s = k_s + NS * T::kBytes;         // NS tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + Cfg::kTileBytes);
  uint64_t* q_empty = q_full + NQ;
  uint64_t* kv_full = q_empty + NQ;
  uint64_t* kv_empty = kv_full + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NQ; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 128);
    }
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

  if (warp == 4) {  // ---- producer: one thread keeps the copies in flight
    if (lane == 0) {
      hopper::tma_prefetch(&maps.q);
      hopper::tma_prefetch(&maps.k);
      hopper::tma_prefetch(&maps.v);
      hopper::Ring qr, kr;
      for (int hh = 0; hh < HPC; ++hh) {
        const int bh = cta.group * HPC + hh, b = bh / p.H, h = bh % p.H;
        hopper::mbar_wait(&q_empty[qr.slot], qr.phase ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full[qr.slot], T::kBytes);
        hopper::tma_load_tile<D>(q_s + qr.slot * T::kBytes, &maps.q,
                                 &q_full[qr.slot], q_block, h, b);
        qr.advance(NQ);
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
  const int row_a = q_block + warp * 16 + g, row_b = row_a + 8;
  hopper::Ring qr, kr;
  for (int hh = 0; hh < HPC; ++hh) {
    const int bh = cta.group * HPC + hh;
    hopper::mbar_wait(&q_full[qr.slot], qr.phase);
    const uint32_t q_tile = hopper::smem_addr(q_s + qr.slot * T::kBytes);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int kv0 = tile * BM;
      hopper::mbar_wait(&kv_full[kr.slot], kr.phase);
      const uint32_t k_tile = hopper::smem_addr(k_s + kr.slot * T::kBytes);
      const uint32_t v_tile = hopper::smem_addr(v_s + kr.slot * T::kBytes);

      // S = Q K^T (64 x 64), both operands from shared memory
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      hopper::fence_regs(s);
      hopper::wgmma_fence();
      hopper::wgmma_abt<D>(s, q_tile, k_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      if (tile == n_tiles - 1) hopper::mbar_arrive(&q_empty[qr.slot]);

      // scale, mask, online softmax; element 4 nb + e of s sits at row
      // (e < 2 ? row_a : row_b), key kv0 + 8 nb + 2t + (e & 1)
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nb * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool keep = col < p.N && (!p.causal || col <= row);
          const float x = keep ? s[4 * nb + e] * p.scale_log2 : kNegInf;
          s[4 * nb + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2f(s[i] - m_r[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_r[r] = l_r[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: P from registers, V through the transpose mode
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
    qr.advance(NQ);

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        head_offset(p, bh, p.o_sb, p.o_sh);
    float l_safe[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_safe[r] = fmaxf(l_r[r], 1e-30f);
      inv[r] = 1.f / l_safe[r];
    }
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      const int col = db * 8 + 2 * t;
      if (row_a < p.N)
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_a * p.o_sn + col) =
            __floats2bfloat162_rn(o[4 * db] * inv[0], o[4 * db + 1] * inv[0]);
      if (row_b < p.N)
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_b * p.o_sn + col) =
            __floats2bfloat162_rn(o[4 * db + 2] * inv[1], o[4 * db + 3] * inv[1]);
    }
    if (t == 0) {
      float* lse = p.lse + (long long)bh * p.N;
      if (row_a < p.N) lse[row_a] = (m_r[0] + log2f(l_safe[0])) * kLn2;
      if (row_b < p.N) lse[row_b] = (m_r[1] + log2f(l_safe[1])) * kLn2;
    }
  }
}

// ------------------------------------------------------------- float32 path

template <int D, int HPC>
struct SimtCfg {
  static constexpr int kTPR = 4;      // threads sharing one query row
  static constexpr int kBlockM = 32;  // query rows per head
  static constexpr int kBlockN = 2048 / D < 64 ? 2048 / D : 64;
  static constexpr int kPer = D / kTPR;  // head dims per thread
  static constexpr int kHeadThreads = kBlockM * kTPR;
  static constexpr int kThreads = kHeadThreads * HPC;
  static constexpr size_t kSmem = size_t(HPC) * 2 * kBlockN * D * sizeof(float);
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

template <int D, int HPC>
__global__ void __launch_bounds__(SimtCfg<D, HPC>::kThreads)
    fwd_f32_simt(const Params p) {
  using Cfg = SimtCfg<D, HPC>;
  constexpr int BM = Cfg::kBlockM, BN = Cfg::kBlockN, TPR = Cfg::kTPR;
  constexpr int PER = Cfg::kPer;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // HPC x BN x D
  float* v_s = k_s + HPC * BN * D;

  const int tid = threadIdx.x;
  const int hh = tid / Cfg::kHeadThreads;
  const int htid = tid % Cfg::kHeadThreads;  // thread within its head
  const int r = htid / TPR;
  const int part = tid % TPR;  // this thread owns dims part + TPR * i
  const hopper::GridTile cta = hopper::grid_tile();
  const int q_block = cta.row * BM;
  const int row = q_block + r;
  const int bh = cta.group * HPC + hh;

  const float* kg = static_cast<const float*>(p.k) +
                    head_offset(p, bh, p.k_sb, p.k_sh);
  const float* vg = static_cast<const float*>(p.v) +
                    head_offset(p, bh, p.v_sb, p.v_sh);
  float q[PER], acc[PER];
  const float* qrow = static_cast<const float*>(p.q) +
                      head_offset(p, bh, p.q_sb, p.q_sh) +
                      (long long)row * p.q_sn;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    q[i] = row < p.N ? qrow[part + TPR * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int n_kv = p.causal ? min(p.N, q_block + BM) : p.N;
  const int n_tiles = (n_kv + BN - 1) / BN;
  const float* kw = k_s + hh * BN * D;
  const float* vw = v_s + hh * BN * D;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BN;
    head_barrier(hh, Cfg::kHeadThreads);
    load_rows_f32<D>(k_s + hh * BN * D, kg, p.k_sn, kv0, BN, p.N, htid,
                     Cfg::kHeadThreads);
    load_rows_f32<D>(v_s + hh * BN * D, vg, p.v_sn, kv0, BN, p.N, htid,
                     Cfg::kHeadThreads);
    head_barrier(hh, Cfg::kHeadThreads);

    float s[BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) x = fmaf(q[i], kw[j * D + part + TPR * i], x);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int col = kv0 + j;
      const bool keep = col < p.N && (!p.causal || col <= row);
      s[j] = keep ? x * p.scale_log2 : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      s[j] = exp2f(s[j] - m);
      sum += s[j];
    }
    l = l * alpha + sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        acc[i] = fmaf(s[j], vw[j * D + part + TPR * i], acc[i]);
  }

  if (row < p.N) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) + head_offset(p, bh, p.o_sb, p.o_sh) +
                  (long long)row * p.o_sn;
#pragma unroll
    for (int i = 0; i < PER; ++i) orow[part + TPR * i] = acc[i] / l_safe;
    if (part == 0)
      p.lse[(long long)bh * p.N + row] = (m + log2f(l_safe)) * kLn2;
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
cudaError_t run(const Params& p, int bf16, cudaStream_t stream) {
  if (bf16) {
    using C = WgmmaCfg<D>;
    FwdMaps maps;
    cudaError_t err = hopper::bind_context();
    const void* src[3] = {p.q, p.k, p.v};
    const long long st[3][3] = {{p.q_sb, p.q_sh, p.q_sn},
                                {p.k_sb, p.k_sh, p.k_sn},
                                {p.v_sb, p.v_sh, p.v_sn}};
    CUtensorMap* dst[3] = {&maps.q, &maps.k, &maps.v};
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = hopper::encode_bhnd(dst[i], src[i], p.B, p.H, p.N, D, st[i][0],
                                st[i][1], st[i][2]);
    if (err != cudaSuccess) return err;
    err = hopper::allow_smem<fwd_bf16_wgmma<D, HPC>>(C::kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.H / HPC, (p.N + C::kBlock - 1) / C::kBlock);
    fwd_bf16_wgmma<D, HPC><<<grid, C::kThreads, C::kSmem, stream>>>(maps, p);
    return cudaGetLastError();
  }
  using C = SimtCfg<D, HPC>;
  const dim3 grid(p.B * p.H / HPC, (p.N + C::kBlockM - 1) / C::kBlockM);
  return launch(fwd_f32_simt<D, HPC>, grid, C::kThreads, C::kSmem, stream, p);
}

template <int HPC>
cudaError_t run_d(const Params& p, int d, int bf16, cudaStream_t stream) {
  switch (d) {
    case 16: return run<16, HPC>(p, bf16, stream);
    case 32: return run<32, HPC>(p, bf16, stream);
    case 64: return run<64, HPC>(p, bf16, stream);
    case 128: return run<128, HPC>(p, bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, H, N, D) with element strides (batch, head, row) and a
// contiguous last dim; every pointer 16-byte aligned and every stride a
// multiple of 16 bytes (the Python wrapper checks). lse: (B*H, N) float32.
// dtype: 0 = float32, 1 = bfloat16. heads_per_cta in {1, 2, 4} divides H.
// Returns cudaGetLastError() after the launch (0 on success).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int N, int D, long long q_sb,
                   long long q_sh, long long q_sn, long long k_sb,
                   long long k_sh, long long k_sn, long long v_sb,
                   long long v_sh, long long v_sn, long long o_sb,
                   long long o_sh, long long o_sn, float sm_scale, int causal,
                   int heads_per_cta, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (B < 1 || H < 1 || N < 1 || heads_per_cta < 1 || H % heads_per_cta)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.N = N;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  p.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads_per_cta) {
    case 1: return run_d<1>(p, D, dtype, s);
    case 2: return run_d<2>(p, D, dtype, s);
    case 4: return run_d<4>(p, D, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
