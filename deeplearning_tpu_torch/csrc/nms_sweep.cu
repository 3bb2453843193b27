// Blocked greedy NMS for Hopper (sm_90a), in two kernels: the suppression
// bitmask in parallel, then one serial scan an image.
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
//     with the alive row resident in VMEM across grid steps, so block i sees
//     block i-1's suppressions. A GPU grid runs in no order, so the work is
//     split where it parallelises: nms_iou_mask computes every IoU > th bit
//     of the strictly upper triangle at once (grid: column word x row word x
//     image, one 64-thread CTA a 64 x 64 tile, one 64-bit word a row), and
//     nms_scan walks the rows in score order in one CTA an image.
//   - The scan keeps a "removed" bitmask of one 64-bit word per 64
//     candidates in shared memory (132 words at N = 8 400). Per word, warp 0
//     stages the 64 diagonal mask words and one thread resolves the word's
//     keeps serially (the greedy order within the word); then the CTA ORs the
//     kept rows' masks into every later word in parallel. It stops at
//     max_out keeps, as the TPU kernel's caller stops at max_out slots.
//   - Sorting puts live candidates first (NaN and -inf scores last), so both
//     kernels stop at the last live candidate (n_live): rows and columns past
//     it are never computed or read.
//   - The mask is stored word-major, (image, word u, row i): the 64 threads
//     of a tile write 64 consecutive rows of one word, so stores coalesce.
//     It takes B * Npad * Npad / 8 bytes of scratch (8.9 MB an image at
//     N = 8 400), allocated by the wrapper.
//   - IoU is ops/boxes.box_iou's arithmetic in float32, every operation
//     rounded alone (__fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, so nvcc
//     cannot contract a multiply-add) with NaN-propagating min/max (torch's
//     maximum/minimum/clamp; fmaxf would drop a NaN), compared with a
//     float32 threshold: the keep set equals the plain version's exactly.
//
// Bound at YOLOX-S serving (B = 32 images, N = 8 400 candidates, all live):
// the mask kernel evaluates N(N-1)/2 IoUs an image at 14 float32 operations
// each, 15.8 GFLOP, 0.24 ms at 67 TFLOP/s, against 144 MB of mask words
// written once, 0.043 ms at 3.35 TB/s (H100 SXM data sheet, 700 W): bound by
// operations. The scan moves a few kB an image (the kept rows' words) and is
// bound by its serial chain of dependent steps, not by either roof. With
// early exit at max_out keeps a greedy sweep needs far fewer IoUs than the
// full triangle (ops/nms.greedy_ious counts them): the mask kernel computes
// the whole triangle anyway, which is this simple design's cost.
//
// Built by deeplearning_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;          // candidates a mask word / a tile side
constexpr int kMaxWords = 4096;    // scan's shared "removed" words (32 kB)
constexpr int kScanThreads = 256;

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
  return __fdiv_rn(inter, max_nan(uni, 1e-9f)) > th;
}

// grid (words, words, B), 64 threads: tile (row word rt, column word ct) of
// image b. Thread t owns row rt*64 + t and writes its 64 bits of word ct.
__global__ void __launch_bounds__(kWord)
iou_mask_kernel(const float4* __restrict__ boxes,
                const int* __restrict__ n_live,
                unsigned long long* __restrict__ mask, int npad, int words,
                float th) {
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  if (ct < rt || ct * kWord >= __ldg(n_live + b)) return;
  __shared__ float4 cbox[kWord];
  __shared__ float carea[kWord];
  const int t = threadIdx.x;
  const float4* img = boxes + static_cast<size_t>(b) * npad;
  const float4 c = img[ct * kWord + t];
  cbox[t] = c;
  carea[t] = area(c);
  __syncthreads();
  const int row = rt * kWord + t;
  const float4 r = img[row];
  const float ra = area(r);
  unsigned long long bits = 0;
  for (int j = (ct == rt) ? t + 1 : 0; j < kWord; ++j)
    if (suppresses(r, ra, cbox[j], carea[j], th)) bits |= 1ull << j;
  mask[(static_cast<size_t>(b) * words + ct) * npad + row] = bits;
}

// grid (B), 256 threads: the greedy walk over image b's rows.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const unsigned long long* __restrict__ mask,
            const uint8_t* __restrict__ alive0,
            const int* __restrict__ n_live, uint8_t* __restrict__ out,
            int npad, int max_out) {
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long diag[kWord];
  __shared__ unsigned long long s_keep;
  __shared__ int s_kept;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = npad / kWord;
  const int live_words = (__ldg(n_live + b) + kWord - 1) / kWord;
  const uint8_t* a0 = alive0 + static_cast<size_t>(b) * npad;
  uint8_t* o = out + static_cast<size_t>(b) * npad;
  const unsigned long long* m =
      mask + static_cast<size_t>(b) * words * npad;

  for (int i = tid; i < npad; i += kScanThreads) o[i] = 0;
  for (int u = tid; u < live_words; u += kScanThreads) {
    unsigned long long dead = 0;
    for (int j = 0; j < kWord; ++j)
      if (!a0[u * kWord + j]) dead |= 1ull << j;
    removed[u] = dead;
  }
  if (tid == 0) s_kept = 0;
  __syncthreads();

  for (int w = 0; w < live_words; ++w) {
    if (tid < 32) {
      // row w*64 + j's bits within its own word (columns > j only)
      const unsigned long long* dw =
          m + static_cast<size_t>(w) * npad + w * kWord;
      diag[tid] = dw[tid];
      diag[tid + 32] = dw[tid + 32];
      __syncwarp();
      if (tid == 0) {
        unsigned long long rem = removed[w], keep = 0;
        int kept = s_kept;
        for (int j = 0; j < kWord && kept < max_out; ++j) {
          if (!((rem >> j) & 1ull)) {
            keep |= 1ull << j;
            ++kept;
            rem |= diag[j];
          }
        }
        s_keep = keep;
        s_kept = kept;
      }
    }
    __syncthreads();
    const unsigned long long keep = s_keep;
    if (tid < kWord) o[w * kWord + tid] = (keep >> tid) & 1ull;
    if (s_kept >= max_out) break;    // uniform: read before any rewrite
    // every kept row of word w removes its suppressed later candidates
    for (int u = w + 1 + tid; u < live_words; u += kScanThreads) {
      const unsigned long long* mu =
          m + static_cast<size_t>(u) * npad + w * kWord;
      unsigned long long acc = 0, k = keep;
      while (k) {
        acc |= mu[__ffsll(static_cast<long long>(k)) - 1];
        k &= k - 1;
      }
      removed[u] |= acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes: (B, npad, 4) float32, contiguous, 16-byte aligned. n_live: (B,)
// int32, one past each image's last live candidate. mask: (B, words, npad)
// 64-bit scratch, words = npad / 64; only the upper-triangular live words
// are written. th: the IoU threshold in float32.
int nms_iou_mask(const void* boxes, const void* n_live, void* mask, int B,
                 int npad, int words, float th, void* stream) {
  if (B < 1 || B > 65535 || npad < kWord || npad % kWord ||
      words != npad / kWord || words > kMaxWords)
    return cudaErrorInvalidValue;
  const dim3 grid(words, words, B);
  iou_mask_kernel<<<grid, kWord, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_live),
      static_cast<unsigned long long*>(mask), npad, words, th);
  return cudaGetLastError();
}

// mask: nms_iou_mask's output. alive0: (B, npad) bool (one byte each).
// out: (B, npad) bool, the first max_out greedy keeps set, all else 0.
int nms_scan(const void* mask, const void* alive0, const void* n_live,
             void* out, int B, int npad, int max_out, void* stream) {
  if (B < 1 || B > 65535 || npad < kWord || npad % kWord ||
      npad / kWord > kMaxWords || max_out < 1)
    return cudaErrorInvalidValue;
  scan_kernel<<<B, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(alive0), static_cast<const int*>(n_live),
      static_cast<uint8_t*>(out), npad, max_out);
  return cudaGetLastError();
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
