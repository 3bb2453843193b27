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
//     grid is (ceil(N / BLOCK_M), B*H / HPC); a loop inside the CTA walks the
//     K/V tiles through shared memory and the ragged edge (rows or keys >= N)
//     is masked in the kernel, so no padded copy of q/k/v is ever made.
//   - The running max m, the running sum l and the O accumulator stay in
//     float32 registers for the whole loop; only O and LSE are written.
//   - bf16: both products use mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//     Each warp owns 16 query rows of one head; S comes out of the first
//     product in the accumulator layout, the softmax runs on those registers
//     (row reductions are two quad shuffles), and P is repacked in registers
//     as the A operand of the second product. Shared-memory rows are padded
//     by 8 elements so every fragment load is free of bank conflicts.
//   - float32: scalar FMA (no tensor cores); four threads share a query row
//     and split the head dimension, reducing each score with two shuffles.
//
// Bound at ViT-B/16 (N = 197, H = 12, D = 64, bf16), one launch per layer at
// batch b: q, k, v and O are b*12*197*64*2 bytes each, LSE b*12*197*4 bytes,
// about 1.22 MB an image; the two products are 4*b*12*197^2*64, about 119
// MFLOP an image. That is ~98 FLOP/byte, under the H100's ~295 FLOP/byte
// ridge, so the kernel is memory-bound: at b = 32 about 11.6 us of HBM time
// against about 3.9 us of tensor-core time (H100 SXM data sheet: 3.35 TB/s,
// 989 TFLOP/s bf16 dense, 700 W). The naive path, by contrast, writes and
// re-reads the b*12*197*197 score and probability tensors.
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; flash_attn_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D, int HPC>
struct MmaCfg {
  static constexpr int kWarpsPerHead = 4;
  static constexpr int kBlockM = 16 * kWarpsPerHead;  // query rows per head
  static constexpr int kBlockN = D <= 64 ? 64 : 32;   // keys per K/V tile
  static constexpr int kStride = D + 8;               // padded smem row
  static constexpr int kHeadThreads = 32 * kWarpsPerHead;
  static constexpr int kThreads = kHeadThreads * HPC;
  static constexpr size_t kSmem =
      size_t(HPC) * (kBlockM + 2 * kBlockN) * kStride * sizeof(__nv_bfloat16);
};

// rows [row0, row0 + rows) of one head into shared memory; rows >= n are
// zero so masked keys contribute exactly 0 * 0 to P V.
template <int D, int STRIDE>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int D, int HPC>
__global__ void __launch_bounds__(MmaCfg<D, HPC>::kThreads)
    fwd_bf16_mma(const Params p) {
  using Cfg = MmaCfg<D, HPC>;
  constexpr int BM = Cfg::kBlockM, BN = Cfg::kBlockN, S = Cfg::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + HPC * BM * S;
  __nv_bfloat16* v_s = k_s + HPC * BN * S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hh = warp / Cfg::kWarpsPerHead;         // head within the CTA
  const int m0 = (warp % Cfg::kWarpsPerHead) * 16;  // warp's 16-row strip
  const int g = lane >> 2, t = lane & 3;            // mma fragment coords
  const int htid = tid % Cfg::kHeadThreads;         // thread within head
  const int q_block = blockIdx.x * BM;
  const int bh = blockIdx.y * HPC + hh;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            head_offset(p, bh, p.q_sb, p.q_sh);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            head_offset(p, bh, p.k_sb, p.k_sh);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            head_offset(p, bh, p.v_sb, p.v_sh);
  load_rows_bf16<D, S>(q_s + hh * BM * S, qg, p.q_sn, q_block, BM, p.N, htid,
                       Cfg::kHeadThreads);

  // causal: keys past the block's last row never contribute
  const int n_kv = p.causal ? min(p.N, q_block + BM) : p.N;
  const int n_tiles = (n_kv + BN - 1) / BN;
  const int row_a = q_block + m0 + g, row_b = row_a + 8;
  const __nv_bfloat16* qw = q_s + hh * BM * S + m0 * S;
  const __nv_bfloat16* kw = k_s + hh * BN * S;
  const __nv_bfloat16* vw = v_s + hh * BN * S;

  float o_acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[db][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BN;
    head_barrier(hh, Cfg::kHeadThreads);  // previous tile consumed, Q stored
    load_rows_bf16<D, S>(k_s + hh * BN * S, kg, p.k_sn, kv0, BN, p.N, htid,
                         Cfg::kHeadThreads);
    load_rows_bf16<D, S>(v_s + hh * BN * S, vg, p.v_sn, kv0, BN, p.N, htid,
                         Cfg::kHeadThreads);
    head_barrier(hh, Cfg::kHeadThreads);

    // S = Q K^T for this warp's 16 rows and the tile's BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t a0 = ld32(qw + g * S + c);
      const uint32_t a1 = ld32(qw + (g + 8) * S + c);
      const uint32_t a2 = ld32(qw + g * S + c + 8);
      const uint32_t a3 = ld32(qw + (g + 8) * S + c + 8);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const __nv_bfloat16* kr = kw + (nb * 8 + g) * S + c;
        mma_bf16(s[nb], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask, online softmax; element e of s[nb] sits at row
    // (e < 2 ? row_a : row_b), key kv0 + nb*8 + 2t + (e & 1)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nb * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool keep = col < p.N && (!p.causal || col <= row);
        const float x = keep ? s[nb][e] * p.scale_log2 : kNegInf;
        s[nb][e] = x;
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
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m_r[e >> 1]);
        sum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[db][e] *= alpha[e >> 1];

    // O += P V: the accumulator layout of two adjacent 8-key blocks of P is
    // the A-operand layout of one 16-key step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const unsigned short* vr =
          reinterpret_cast<const unsigned short*>(vw + (kk * 16 + 2 * t) * S);
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        const int col = db * 8 + g;
        const uint32_t b0 = uint32_t(vr[col]) | (uint32_t(vr[S + col]) << 16);
        const uint32_t b1 =
            uint32_t(vr[8 * S + col]) | (uint32_t(vr[9 * S + col]) << 16);
        mma_bf16(o_acc[db], a0, a1, a2, a3, b0, b1);
      }
    }
  }

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
          __floats2bfloat162_rn(o_acc[db][0] * inv[0], o_acc[db][1] * inv[0]);
    if (row_b < p.N)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_b * p.o_sn + col) =
          __floats2bfloat162_rn(o_acc[db][2] * inv[1], o_acc[db][3] * inv[1]);
  }
  if (t == 0) {
    float* lse = p.lse + (long long)bh * p.N;
    if (row_a < p.N) lse[row_a] = (m_r[0] + log2f(l_safe[0])) * kLn2;
    if (row_b < p.N) lse[row_b] = (m_r[1] + log2f(l_safe[1])) * kLn2;
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
  const int q_block = blockIdx.x * BM;
  const int row = q_block + r;
  const int bh = blockIdx.y * HPC + hh;

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
    using C = MmaCfg<D, HPC>;
    const dim3 grid((p.N + C::kBlockM - 1) / C::kBlockM, p.B * p.H / HPC);
    return launch(fwd_bf16_mma<D, HPC>, grid, C::kThreads, C::kSmem, stream, p);
  }
  using C = SimtCfg<D, HPC>;
  const dim3 grid((p.N + C::kBlockM - 1) / C::kBlockM, p.B * p.H / HPC);
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
