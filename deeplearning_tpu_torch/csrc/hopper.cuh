// Hopper building blocks shared by the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, window_attn_fwd.cu): mbarriers, TMA tile loads and
// stores through a tensor map, the wgmma shared-memory descriptor, the
// wgmma products those kernels issue, and their grid's coordinates; and,
// for every kernel, the host call that lets it use more than 48 kB of
// dynamic shared memory. sm_90a only (wgmma does not exist on plain sm_90).
//
// Tiles. Every bf16 operand tile is 64 rows of a (rows, D) head slice, as
// one TMA load per panel lands it in shared memory: D is cut into panels
// of min(D, 64) columns, and each panel is 64 rows of 32, 64 or 128 bytes
// stored with the TMA swizzle of that span (32B, 64B or 128B). A tile of
// D = 256 is four 64-column panels, and its columns 128c .. 128c + 127
// (panels 2c, 2c + 1) are laid out exactly as a whole D = 128 tile: a
// kernel that owns only those output columns reads them as Tile<128> at
// byte offset 2c * kPanelBytes. The wgmma
// descriptors below name the same swizzle, so the tensor cores read the
// tile exactly as the copy engine wrote it:
//   K-major (the reduction runs along D: Q and K in S = Q K^T, K and Q in
//     S^T = K Q^T): the 16 columns of k-step kk start 32 * (kk mod
//     per-panel) bytes into the row of panel kk / per-panel; 8-row groups
//     are 8 * row bytes apart (SBO).
//   MN-major (the reduction runs along the rows: V in P V, dO and Q in
//     P^T dO and dS^T Q; the "transpose" mode): k-step kk starts 16 rows
//     further down; 8-row groups are SBO apart and panels LBO apart.
// Each tile starts on a 1024-byte boundary so the swizzle phase (address
// bits 4-6 XOR 7-9) is the same for TMA and wgmma.
//
// Tensor maps are encoded on the host for each call (the operands are
// strided views whose strides change between callers) through the driver
// entry point cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint
// so the libraries need no -lcuda, and passed to the kernel as
// __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------- tile shape
template <int D>
struct Tile {
  static constexpr int kRows = 64;
  static constexpr int kPanelCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kPanelCols * 2;             // 32, 64, 128
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kPanelBytes = kRows * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;         // 64 * D * 2
  static constexpr int kGroupBytes = 8 * kRowBytes;            // SBO
  // descriptor layout code: 1 = 128B swizzle, 2 = 64B, 3 = 32B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static_assert(kBytes % 1024 == 0, "tiles keep 1024-byte alignment");
};

// The output columns a flash-attention CTA owns: all of D, or 128 of
// D = 256 (kColBlocks CTAs a row block), read as a Tile<128> at byte
// offset col * TO::kBytes of a D = 256 tile.
template <int D>
struct ColSplit {
  static constexpr int kCols = D > 128 ? 128 : D;
  static constexpr int kColBlocks = D / kCols;
  using TO = Tile<kCols>;
};

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival that also announces `bytes` of copies completing on `bar`
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A ring slot: its index and the parity of the phase a waiter waits for.
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void advance(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// -------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// one box {cols, 64 rows, 1 head, 1 batch} of a rank-4 (D, N, H, B) map
// into shared memory at dst, completing on bar; rows past N read as zero
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// a whole 64-row tile of D columns, columns col0 .. col0 + D - 1 of the
// map's rows: one box per panel
template <int D>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int head,
                                              int batch, int col0 = 0) {
  using T = Tile<D>;
#pragma unroll
  for (int pn = 0; pn < T::kPanels; ++pn)
    tma_load_4d(static_cast<char*>(dst) + pn * T::kPanelBytes, map, bar,
                col0 + pn * T::kPanelCols, row, head, batch);
}

// one box of a rank-4 map from shared memory at src to device memory; rows
// past the map's N are not written. Completes in the issuing thread's bulk
// group: commit it with bulk_commit, and wait with bulk_wait_read before src
// is written again (or the CTA exits).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int col, int row,
                                             int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed stores still read shared
// memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// makes this thread's plain shared-memory writes visible to the copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over `nthreads` threads on named barrier `id` (0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

// K-major descriptor of k-step kk (16 columns of D) of a tile at `tile`
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tile<D>;
  constexpr int kPer = T::kPanelCols / 16;  // k-steps in one panel
  const uint32_t addr =
      tile + (kk / kPer) * T::kPanelBytes + (kk % kPer) * 32;
  return make_desc(addr, 16, T::kGroupBytes, T::kLayout);
}

// MN-major descriptor of k-step kk (16 rows) of a tile at `tile`
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using T = Tile<D>;
  return make_desc(tile + kk * 16 * T::kRowBytes, T::kPanelBytes,
                   T::kGroupBytes, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (issued, then waited for)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of a 64 x N product holds, in thread t of the warpgroup,
// element 4 * nb + e at row 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2),
// column 8 * nb + 2 * (t % 4) + (e % 2). Two adjacent 8-column blocks
// (2 kk, 2 kk + 1) of it, rounded to bf16, are exactly the register A
// operand of k-step kk of a following product.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&x)[R], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
}

// d(64 x 64, f32) (+)= A(64 x 16) B(16 x 64), A and B both read from shared
// memory through K-major descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d(64 x 16, f32) += A(64 x 16, bf16 registers) B(16 x 16), B read from
// shared memory through an MN-major (transposed) descriptor.
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d(64 x 32, f32) += A(64 x 16, bf16 registers) B(16 x 32), B read from
// shared memory through an MN-major (transposed) descriptor.
__device__ __forceinline__ void wgmma_rs_n32_tb(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d(64 x 64, f32) += A(64 x 16, bf16 registers) B(16 x 64), B read from
// shared memory through an MN-major (transposed) descriptor.
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d(64 x 128, f32) += A(64 x 16, bf16 registers) B(16 x 128), B read from
// shared memory through an MN-major (transposed) descriptor.
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d(64 x D) += A(64 x 16, registers) B(16 x D) for D in {16, 32, 64, 128}
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (D == 16) wgmma_rs_n16_tb(d, a, desc_b);
  else if constexpr (D == 32) wgmma_rs_n32_tb(d, a, desc_b);
  else if constexpr (D == 64) wgmma_rs_n64_tb(d, a, desc_b);
  else wgmma_rs_n128_tb(d, a, desc_b);
}

// S(64 x 64) = A(64 x D) B(64 x D)^T, both tiles K-major in shared memory
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&s)[32], uint32_t a_tile,
                                          uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<D>(a_tile, kk), desc_k<D>(b_tile, kk), kk > 0);
}

// The 64 x 64 accumulator x, rounded to bf16, as the A operands of the four
// k-steps of a following product. Packed before the wgmma.fence that
// precedes that product: the fence orders these register writes before the
// asynchronous reads.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(x, kk, a[kk]);
}

// keeps packed A operands live until the products that read them are done
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// O(64 x D) += X(64 x 64, packed A operands) B(64 x D), B's tile read
// through the transpose mode
template <int D>
__device__ __forceinline__ void wgmma_xb(float (&o)[D / 2], const uint32_t (&a)[4][4],
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(o, a[kk], desc_mn<D>(b_tile, kk));
}

// ------------------------------------------------------------------ grid
// The flash-attention grids are (B * H / heads_per_cta, row blocks *
// column blocks): the head groups go on grid.x, whose limit is 2^31 - 1,
// so no batch size can overflow it (grid.y stops at 65535). The CTA's
// coordinates are taken from its linear index with the column block
// counted fastest, then the row block, the order a (column blocks, row
// blocks, head groups) grid would run in: the CTAs of one head run together
// and share that head's tiles through L2. A column block is the 128
// output columns a CTA owns at D = 256 (n_col = 2); below that n_col is 1.
struct GridTile {
  int row;    // row block: query rows (or keys) 64 * row ...
  int group;  // head group: heads group * heads_per_cta ...
  int col;    // column block: output columns 128 * col ...
};

__device__ __forceinline__ GridTile grid_tile(int n_col = 1) {
  const unsigned long long linear =
      (unsigned long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int rc = int(linear % gridDim.y);
  return {rc / n_col, int(linear / gridDim.y), rc % n_col};
}

// ------------------------------------------------------------ host: launch
// Lets Kernel use `bytes` of dynamic shared memory on the current device.
// Set once a device (not on every launch), so a launch inside a CUDA-graph
// capture makes no attribute call.
template <auto Kernel>
inline cudaError_t allow_smem(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// ------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled, a driver call, needs a context current on the
// calling thread, and a thread that has run no CUDA work through the
// runtime yet (autograd's worker before its first kernel, a server's
// dispatch thread) has none: it then fails with "invalid argument". So the
// first launch from each thread makes the current device's primary context
// current, as a runtime launch would lazily (once a thread: never inside a
// CUDA-graph capture, which replays warmed-up calls).
inline cudaError_t bind_context() {
  static thread_local bool bound = false;
  if (bound) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  bound = err == cudaSuccess;
  return err;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The tensor map of a bf16 (B, H, N, D) view with element strides
// (sb, sh, sn) and a contiguous last dim, cut in 64-row boxes of one panel
// (min(D, 64) columns) with the panel's swizzle. Rows past N read as 0.
// swizzled = false: boxes of all D columns (D <= 256), stored row after row
// with no swizzle, the layout of an output staged for tma_store_4d.
inline cudaError_t encode_bhnd(CUtensorMap* map, const void* base, int B, int H,
                               int N, int D, long long sb, long long sh,
                               long long sn, bool swizzled = true) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int panel = !swizzled ? D : D < 64 ? D : 64;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(N), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sn) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(panel), 64u, 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle =
      !swizzled ? CU_TENSOR_MAP_SWIZZLE_NONE
      : panel == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : panel == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
