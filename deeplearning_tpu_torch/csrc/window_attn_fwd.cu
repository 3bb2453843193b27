// Fused window attention forward for Hopper (sm_90a): Swin's per-window
// attention with the relative-position bias and the shift mask added inside
// the kernel, never writing the (N, N) score matrix to device memory.
//
// Replaces the TPU Pallas kernel deeplearning_tpu/ops/pallas/window_attention.py
//   _attn_kernel (:43), reached through window_attention (:65-120).
//
// What it computes, per (window w, head h), with N = window^2 <= 64 tokens:
//   S = (Q K^T) * d^-1/2 + bias[h] + mask[w mod nW]   (float32)
//   P = softmax(S)                                     (float32, rows)
//   O = P' V   with P' = P cast to V's dtype, float32 accumulation,
// written as O[w, n, h*d + c] in the input dtype: the (BW, N, heads*d)
// layout the output projection consumes.
//
// Design against the TPU original:
//   - The Pallas call padded N = 49 to 56 with -1e9 keys, moved q/k/v to
//     (BW, heads, Np, d) copies and pre-combined bias and mask host-side into
//     one (lcm(nW, wb), heads, Np, Np) tensor picked per block by an index
//     map. Here q, k and v are read straight from the strided
//     (BW, N, 3, heads, d) view of the qkv projection (no copies), keys >= N
//     are masked in registers, and bias (heads, N, N) and mask (nW, N, N)
//     are separate float32 inputs: window w simply reads mask row w mod nW,
//     the row the reference picks with reshape(bw / nw, nw, ...).
//   - The grid is (ceil(BW / windows_per_block), heads): a CTA takes
//     windows_per_block windows of one head, and each of its 4 warps owns one
//     (window, head) pair at a time. A warp stages K and V in its own slice
//     of shared memory (rows padded to 16, zero past N, row stride D + 8
//     against bank conflicts) and needs only __syncwarp, never a CTA barrier.
//   - bf16: both products use mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//     The warp walks the window's query rows in strips of 16; Q fragments
//     come straight from global memory, S leaves the first product in the
//     accumulator layout, the whole softmax runs on those registers (every
//     key fits, so no online rescaling), and P is normalised, rounded to bf16
//     and repacked in registers as the A operand of P V.
//   - float32: scalar FMA; four lanes share a query row and split the head
//     dimension, reducing each score with two shuffles.
//
// Bound at Swin-T stage 1 (batch b, BW = 64 b windows, N = 49, heads = 3,
// d = 32, bf16): q, k, v read once and O written once move 4 * 64b*49*96*2
// bytes, about 2.41 MB an image, plus the bias and mask tables (0.6 MB, once);
// the products are 4 * 64b*49*49*96, about 59 MFLOP an image. That is ~24
// FLOP/byte, far under the H100's ~295 FLOP/byte ridge, so the kernel is
// bound by device-memory bytes: at b = 128 about 92 us of HBM time against
// 7.6 us of tensor-core time (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s
// bf16 dense, 700 W). The bias and mask are re-read for every window from
// L1/L2, not from device memory.
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; window_attn_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps a CTA, one (window, head) each
constexpr int kMaxTokens = 64;     // a window of at most 8 x 8
constexpr float kMasked = -1e30f;  // keys past N
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* qkv;    // q of window 0, row 0, head 0
  const float* bias;  // (H, N, N)
  const float* mask;  // (nW, N, N) or null
  void* o;            // (BW, N, H * D): windows o_sw apart, rows o_sn apart
  int BW, N, H, nW, wb;
  long long s_w, s_n, s_3, s_h;  // element strides of the qkv view
  long long o_sw, o_sn;
  float scale;
};

// the additive term of score (row, col), both < N: bias + mask
__device__ __forceinline__ float additive(const float* bias_h,
                                          const float* mask_w, int n, int row,
                                          int col) {
  const int i = row * n + col;
  float x = __ldg(bias_h + i);
  if (mask_w) x += __ldg(mask_w + i);
  return x;
}

// ---------------------------------------------------------------- bf16 path

template <int D, int NT>
struct Bf16Cfg {
  static constexpr int kRows = 16 * NT;  // keys padded to a multiple of 16
  static constexpr int kStride = D + 8;  // padded smem row
  static constexpr size_t kSmem =
      size_t(kWarps) * 2 * kRows * kStride * sizeof(__nv_bfloat16);
};

// rows [0, rows) of K or V into the warp's shared memory; rows >= n are zero
// so masked keys contribute exactly 0 * 0 to P V
template <int D, int STRIDE>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long sn, int rows, int n,
                                               int lane) {
  constexpr int kVec = 8;  // 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = lane; i < rows * kPerRow; i += 32) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + (long long)r * sn + c);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* ptr) {
  return __ldg(reinterpret_cast<const unsigned int*>(ptr));
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

template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32) win_bf16_mma(const Params p) {
  using Cfg = Bf16Cfg<D, NT>;
  constexpr int R = Cfg::kRows, S = Cfg::kStride, KB = R / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coords
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw) +
                       warp * 2 * R * S;
  __nv_bfloat16* v_s = k_s + R * S;
  const int n = p.N, h = blockIdx.y;
  const int w0 = blockIdx.x * p.wb;
  const int nwin = min(p.wb, p.BW - w0);
  const float* bias_h = p.bias + (long long)h * n * n;

  for (int item = warp; item < nwin; item += kWarps) {
    const int w = w0 + item;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.qkv) +
                              (long long)w * p.s_w + (long long)h * p.s_h;
    __syncwarp();  // the previous window's reads of k_s / v_s are done
    load_rows_bf16<D, S>(k_s, qg + p.s_3, p.s_n, R, n, lane);
    load_rows_bf16<D, S>(v_s, qg + 2 * p.s_3, p.s_n, R, n, lane);
    __syncwarp();
    const float* mask_w =
        p.mask ? p.mask + (long long)(w % p.nW) * n * n : nullptr;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        (long long)w * p.o_sw + (long long)h * D;

#pragma unroll 1
    for (int strip = 0; strip < NT; ++strip) {
      const int row_a = strip * 16 + g, row_b = row_a + 8;
      // S = Q K^T for the strip's 16 rows and all R keys
      float s[KB][4];
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        const __nv_bfloat16* qa = qg + (long long)row_a * p.s_n + c;
        const __nv_bfloat16* qb = qg + (long long)row_b * p.s_n + c;
        const uint32_t a0 = row_a < n ? ldg32(qa) : 0u;
        const uint32_t a1 = row_b < n ? ldg32(qb) : 0u;
        const uint32_t a2 = row_a < n ? ldg32(qa + 8) : 0u;
        const uint32_t a3 = row_b < n ? ldg32(qb + 8) : 0u;
#pragma unroll
        for (int nb = 0; nb < KB; ++nb) {
          const __nv_bfloat16* kr = k_s + (nb * 8 + g) * S + c;
          mma_bf16(s[nb], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
        }
      }

      // scale, bias, mask, softmax; element e of s[nb] sits at row
      // (e < 2 ? row_a : row_b), key nb*8 + 2t + (e & 1). The softmax runs
      // in base 2 on x * log2(e).
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          float x = kMasked;
          if (col < n)
            x = row < n ? (s[nb][e] * p.scale +
                           additive(bias_h, mask_w, n, row, col)) * kLog2e
                        : 0.f;  // a padded query row: computed, never stored
          s[nb][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = exp2f(s[nb][e] - mx[e >> 1]);
          sum[e >> 1] += s[nb][e];
        }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = 1.f / sum[r];
      }

      // O = P' V with P' = bf16(P / sum), as the TPU kernel normalises P
      // before casting it; the accumulator layout of two adjacent 8-key
      // blocks of P is the A-operand layout of one 16-key step
      float o_acc[D / 8][4];
#pragma unroll
      for (int db = 0; db < D / 8; ++db)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[db][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const uint32_t a0 = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
        const uint32_t a1 = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
        const uint32_t a2 =
            pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]);
        const uint32_t a3 =
            pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]);
        const unsigned short* vr =
            reinterpret_cast<const unsigned short*>(v_s + (kk * 16 + 2 * t) * S);
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          const int col = db * 8 + g;
          const uint32_t b0 = uint32_t(vr[col]) | (uint32_t(vr[S + col]) << 16);
          const uint32_t b1 =
              uint32_t(vr[8 * S + col]) | (uint32_t(vr[9 * S + col]) << 16);
          mma_bf16(o_acc[db], a0, a1, a2, a3, b0, b1);
        }
      }
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        const int col = db * 8 + 2 * t;
        if (row_a < n)
          *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_a * p.o_sn + col) =
              __floats2bfloat162_rn(o_acc[db][0], o_acc[db][1]);
        if (row_b < n)
          *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_b * p.o_sn + col) =
              __floats2bfloat162_rn(o_acc[db][2], o_acc[db][3]);
      }
    }
  }
}

// ------------------------------------------------------------- float32 path

template <int D, int NT>
struct F32Cfg {
  static constexpr int kRows = 16 * NT;
  static constexpr size_t kSmem = size_t(kWarps) * 2 * kRows * D * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long sn, int rows, int n,
                                              int lane) {
  constexpr int kVec = 4;  // 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = lane; i < rows * kPerRow; i += 32) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) val = *reinterpret_cast<const float4*>(src + (long long)r * sn + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = val;
  }
}

template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32) win_f32_simt(const Params p) {
  constexpr int R = F32Cfg<D, NT>::kRows;
  constexpr int TPR = 4;          // lanes sharing one query row
  constexpr int PER = D / TPR;    // head dims a lane owns: part + TPR * i
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* k_s = reinterpret_cast<float*>(smem_raw) + warp * 2 * R * D;
  float* v_s = k_s + R * D;
  const int r_in = lane / TPR, part = lane % TPR;
  const int n = p.N, h = blockIdx.y;
  const int w0 = blockIdx.x * p.wb;
  const int nwin = min(p.wb, p.BW - w0);
  const float* bias_h = p.bias + (long long)h * n * n;

  for (int item = warp; item < nwin; item += kWarps) {
    const int w = w0 + item;
    const float* qg = static_cast<const float*>(p.qkv) + (long long)w * p.s_w +
                      (long long)h * p.s_h;
    __syncwarp();
    load_rows_f32<D>(k_s, qg + p.s_3, p.s_n, R, n, lane);
    load_rows_f32<D>(v_s, qg + 2 * p.s_3, p.s_n, R, n, lane);
    __syncwarp();
    const float* mask_w =
        p.mask ? p.mask + (long long)(w % p.nW) * n * n : nullptr;
    float* og = static_cast<float*>(p.o) + (long long)w * p.o_sw +
                (long long)h * D;

    for (int r0 = 0; r0 < n; r0 += 32 / TPR) {  // warp-uniform bound
      const int row = r0 + r_in;
      const bool valid = row < n;
      float q[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i)
        q[i] = valid ? __ldg(qg + (long long)row * p.s_n + part + TPR * i) : 0.f;
      float s[R];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) x = fmaf(q[i], k_s[j * D + part + TPR * i], x);
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        float y = kMasked;
        if (j < n)
          y = valid ? (x * p.scale + additive(bias_h, mask_w, n, row, j)) * kLog2e
                    : 0.f;
        s[j] = y;
        mx = fmaxf(mx, y);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[j] = exp2f(s[j] - mx);
        sum += s[j];
      }
      const float inv = 1.f / sum;
      float acc[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float pj = s[j] * inv;
#pragma unroll
        for (int i = 0; i < PER; ++i)
          acc[i] = fmaf(pj, v_s[j * D + part + TPR * i], acc[i]);
      }
      if (valid) {
#pragma unroll
        for (int i = 0; i < PER; ++i)
          og[(long long)row * p.o_sn + part + TPR * i] = acc[i];
      }
    }
  }
}

// ----------------------------------------------------------------- dispatch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int NT>
cudaError_t run(const Params& p, int bf16, cudaStream_t stream) {
  const dim3 grid((p.BW + p.wb - 1) / p.wb, p.H);
  if (bf16)
    return launch(win_bf16_mma<D, NT>, grid, Bf16Cfg<D, NT>::kSmem, stream, p);
  return launch(win_f32_simt<D, NT>, grid, F32Cfg<D, NT>::kSmem, stream, p);
}

template <int D>
cudaError_t run_nt(const Params& p, int bf16, cudaStream_t stream) {
  switch ((p.N + 15) / 16) {
    case 1: return run<D, 1>(p, bf16, stream);
    case 2: return run<D, 2>(p, bf16, stream);
    case 3: return run<D, 3>(p, bf16, stream);
    case 4: return run<D, 4>(p, bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qkv: a (BW, N, 3, H, D) view with element strides (s_w, s_n, s_3, s_h) and
// a contiguous last dim; its base 16-byte aligned and every stride a multiple
// of 16 bytes (the Python wrapper checks). bias: (H, N, N) float32,
// contiguous. mask: (nW, N, N) float32, contiguous, or null (then nW is 1).
// o: (BW, N, H * D) in qkv's dtype with window stride o_sw and row stride
// o_sn. dtype: 0 = float32, 1 = bfloat16. windows_per_block: windows a CTA
// takes (of one head). Returns cudaGetLastError() after the launch.
int window_attn_fwd(const void* qkv, const void* bias, const void* mask,
                    void* o, int BW, int N, int H, int D, int nW,
                    int windows_per_block, long long s_w, long long s_n,
                    long long s_3, long long s_h, long long o_sw,
                    long long o_sn, float scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (BW < 1 || N < 1 || N > kMaxTokens || H < 1 || H > 65535 || nW < 1 ||
      windows_per_block < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.qkv = qkv;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.o = o;
  p.BW = BW; p.N = N; p.H = H; p.nW = mask ? nW : 1;
  p.wb = windows_per_block;
  p.s_w = s_w; p.s_n = s_n; p.s_3 = s_3; p.s_h = s_h;
  p.o_sw = o_sw; p.o_sn = o_sn;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run_nt<16>(p, dtype, s);
    case 32: return run_nt<32>(p, dtype, s);
    case 64: return run_nt<64>(p, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
