// Greedy NMS for Hopper (sm_90a) in one sweep: one CTA an image walks the
// score-sorted candidates in order, 64 at a time, and stops at max_out keeps.
//
// Replaces the TPU Pallas kernel deeplearning_tpu/ops/pallas/nms.py
//   _nms_sweep_kernel (:45), reached through nms_pallas (:111-141).
//
// What it computes, per image, over candidates already sorted by descending
// score and padded to a multiple of 64 (ops/nms.sort_pad_candidates): the
// alive mask of greedy NMS, i.e. candidate i is kept iff it is live
// (alive0) and no kept candidate j < i has IoU(j, i) > threshold, with only
// the first max_out keeps marked (every later position is 0).
//
// Design against the TPU original:
//   - The Pallas grid walks blocks of 256 candidates in order on one core,
//     with the alive row resident in VMEM across grid steps, and pushes each
//     block's keeps forward: one (block, N) IoU tile suppresses every later
//     candidate. A GPU grid runs in no order, so the in-order walk is one
//     CTA (images on grid.x), and each block pulls instead of pushing: a
//     candidate is tested only against the boxes kept before it, which is
//     all greedy needs, and the walk stops at max_out keeps. Nothing of the
//     N x N IoU matrix is computed ahead or stored.
//   - Per block of 64 candidates, 1024 threads in three steps:
//       (a) 16 threads a candidate test it against the kept boxes, each a
//           strided sixteenth of them, four IoUs in flight, stopping once
//           one suppresses it. The kept boxes (and their areas) sit in
//           dynamic shared memory sized for min(max_out, Npad) of them, up
//           to kMaxKeptSmem (10 240, 200 kB); later ones in a global list
//           the wrapper allocates only when max_out can pass that;
//       (b) 16 threads a row form the block's strictly upper 64 x 64
//           IoU > th bits, among the candidates that (a) left live;
//       (c) warp 0 resolves the block's keeps in greedy order, taking the
//           first live candidate (ffs over the block's word), removing the
//           bits of its row and repeating, then appends them to the kept
//           list and marks them in the output.
//   - Sorting puts live candidates first (NaN and -inf scores last), so the
//     walk also stops at the last live candidate (n_live). The sort, the
//     padding and the emit stay torch ops around the kernel.
//   - IoU is ops/boxes.box_iou's arithmetic in float32, every operation
//     rounded alone (__fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, so nvcc
//     cannot contract a multiply-add) with NaN-propagating min/max (torch's
//     maximum/minimum/clamp; fmaxf would drop a NaN), compared with a
//     float32 threshold: the keep set equals the plain version's exactly.
//
// Bound: greedy's own need, from the data (ops/nms.greedy_ious): each live
// candidate up to the max_out-th keep tested against every box kept before
// it, 14 float32 operations an IoU, and those candidates' boxes and live
// flags read once and the output written once. At YOLOX-S serving (32
// images of 8 400 candidates, max_out 100) that is about 158 k IoUs, a
// few MB: far below either roof, so the walk's serial chain (three
// barriers a block) sets the time. The worst case is few suppressions with
// max_out >= n_live: O(n_live x keeps) IoUs in one CTA, i.e. on one SM
// (about 200 M IoUs at 20 000 boxes), bound by that SM's issue rate.
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;                // candidates a block: one word
constexpr int kThreads = 1024;
constexpr int kPer = kThreads / kBlock;   // threads a candidate, a row
constexpr int kUnroll = 4;                // IoUs a thread has in flight
constexpr int kMaxKeptSmem = 10240;       // kept boxes shared memory holds
constexpr size_t kKeptBytes = sizeof(float4) + sizeof(float);  // box, area

// torch.maximum / torch.minimum / clamp: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f),
                   max_nan(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(r, c) > th with box_iou's operation order:
// inter / max(area_r + area_c - inter, 1e-9)
__device__ __forceinline__ bool suppresses(float4 r, float ra, float4 c,
                                           float ca, float th) {
  const float w = max_nan(__fsub_rn(min_nan(r.z, c.z), max_nan(r.x, c.x)),
                          0.f);
  const float h = max_nan(__fsub_rn(min_nan(r.w, c.w), max_nan(r.y, c.y)),
                          0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  // disjoint boxes: inter is +0, so the quotient is +0, or NaN when an area
  // is NaN; the same answer without the division
  if (inter == 0.f) return uni == uni && 0.f > th;
  return __fdiv_rn(inter, max_nan(uni, 1e-9f)) > th;
}

// grid (B), kThreads threads: the greedy walk over image b's candidates.
// Dynamic shared memory: kept boxes then their areas, smem_cap of each.
__global__ void __launch_bounds__(kThreads)
nms_greedy_sweep_kernel(const float4* __restrict__ boxes,
                        const uint8_t* __restrict__ alive0,
                        const int* __restrict__ n_live,
                        float4* __restrict__ spill, uint8_t* __restrict__ out,
                        int npad, int smem_cap, int spill_cap, int max_out,
                        float th) {
  extern __shared__ float4 kept_box[];    // smem_cap boxes
  float* kept_area = reinterpret_cast<float*>(kept_box + smem_cap);
  __shared__ float4 blk_box[kBlock];
  __shared__ float blk_area[kBlock];
  __shared__ unsigned long long row_bits[kBlock];
  __shared__ uint8_t live[kBlock];  // alive, not suppressed by an earlier block
  __shared__ int s_kept;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float4* img = boxes + static_cast<size_t>(b) * npad;
  const uint8_t* a0 = alive0 + static_cast<size_t>(b) * npad;
  uint8_t* o = out + static_cast<size_t>(b) * npad;
  float4* sp = spill + static_cast<size_t>(b) * spill_cap;
  const int n = __ldg(n_live + b);
  for (int i = tid; i < npad; i += kThreads) o[i] = 0;
  if (tid == 0) s_kept = 0;
  __syncthreads();

  const int j = tid / kPer, part = tid % kPer;  // candidate (a), row (b)
  for (int start = 0; start < n; start += kBlock) {
    const int kept = s_kept;  // uniform: written before the last barrier
    if (kept >= max_out) break;

    // (a) candidate start + j against every box kept so far
    const float4 cb = img[start + j];
    const float ca = area(cb);
    const bool alive = a0[start + j] != 0;
    bool hit = false;
    if (alive) {
      const int in_smem = min(kept, smem_cap);
      for (int i = part; i < in_smem && !hit; i += kUnroll * kPer) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = i + u * kPer;
          if (x < in_smem) hit |= suppresses(kept_box[x], kept_area[x], cb, ca, th);
        }
      }
      for (int i = smem_cap + part; i < kept && !hit; i += kUnroll * kPer) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = i + u * kPer;
          if (x < kept) {
            const float4 kb = sp[x - smem_cap];
            hit |= suppresses(kb, area(kb), cb, ca, th);
          }
        }
      }
    }
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (part == 0) {
      blk_box[j] = cb;
      blk_area[j] = ca;
      live[j] = alive && !((hits >> (lane & ~(kPer - 1))) & ((1u << kPer) - 1));
    }
    __syncthreads();

    // (b) row j's bits: live later candidates of the block it suppresses
    unsigned long long bits = 0;
    if (live[j]) {
      const float4 rb = blk_box[j];
      const float ra = blk_area[j];
#pragma unroll
      for (int q = 0; q < kBlock / kPer; ++q) {
        const int col = part * (kBlock / kPer) + q;
        if (col > j && live[col] &&
            suppresses(rb, ra, blk_box[col], blk_area[col], th))
          bits |= 1ull << col;
      }
    }
#pragma unroll
    for (int m = 1; m < kPer; m <<= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, m);
    if (part == 0) row_bits[j] = bits;
    __syncthreads();

    // (c) warp 0: the block's keeps in greedy order, appended to the list
    if (tid < 32) {
      unsigned long long avail =
          static_cast<unsigned long long>(__ballot_sync(0xffffffffu, live[lane])) |
          (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, live[lane + 32]))
           << 32);
      unsigned long long keep = 0;
      int k = kept;
      while (avail && k < max_out) {
        const int x = __ffsll(static_cast<long long>(avail)) - 1;
        keep |= 1ull << x;
        ++k;
        avail &= ~(row_bits[x] | (1ull << x));
      }
      for (int x = lane; x < kBlock; x += 32) {
        if (!((keep >> x) & 1ull)) continue;
        const int pos = kept + __popcll(keep & ((1ull << x) - 1));
        if (pos < smem_cap) {
          kept_box[pos] = blk_box[x];
          kept_area[pos] = blk_area[x];
        } else {
          sp[pos - smem_cap] = blk_box[x];
        }
        o[start + x] = 1;
      }
      if (lane == 0) s_kept = k;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes: (B, npad, 4) float32, contiguous, 16-byte aligned. alive0: (B, npad)
// bool (one byte each). n_live: (B,) int32, one past each image's last live
// candidate. spill: (B, spill_cap, 4) float32 scratch for the kept boxes past
// the first 10 240, spill_cap >= min(max_out, npad) - 10 240 (null when that
// is <= 0). out: (B, npad) bool, the first max_out greedy keeps set, all
// else 0. th: the IoU threshold in float32.
int nms_greedy_sweep(const void* boxes, const void* alive0, const void* n_live,
                     void* spill, void* out, int B, int npad, int spill_cap,
                     int max_out, float th, void* stream) {
  const int most = max_out < npad ? max_out : npad;  // keeps possible
  const int smem_cap = most < kMaxKeptSmem ? most : kMaxKeptSmem;
  if (B < 1 || npad < kBlock || npad % kBlock || max_out < 1 ||
      spill_cap < 0 || (spill_cap > 0 && spill == nullptr) ||
      spill_cap < most - smem_cap)
    return cudaErrorInvalidValue;
  const cudaError_t err = hopper::allow_smem<nms_greedy_sweep_kernel>(
      kMaxKeptSmem * kKeptBytes);
  if (err != cudaSuccess) return err;
  nms_greedy_sweep_kernel<<<B, kThreads, smem_cap * kKeptBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(alive0),
      static_cast<const int*>(n_live), static_cast<float4*>(spill),
      static_cast<uint8_t*>(out), npad, smem_cap, spill_cap, max_out, th);
  return cudaGetLastError();
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
