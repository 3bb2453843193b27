// The C++ half of ops/kernels.define_op: the forward kernel ops of the port
// registered with the dispatcher from C++, so a process without Python (the
// AOTInductor runner, native/aoti_runner.cc) runs an exported package whose
// graph calls them. The schemas are the Python ones character for character:
//   dltpu::flash_fwd    ops/flash_attention.py (K1's forward)
//   dltpu::window_attn  ops/window_attention.py (K2)
//   dltpu::nms_sweep    ops/nms.py (K3)
// Each op has a CPU impl, the plain version written in ATen in the order of
// operations of flash_attention_reference, window_attention_plain and
// nms_sweep_plain, and (built with -DDLTPU_WITH_CUDA) a CUDA impl that does
// what the Python wrapper does before a launch (the head-dim pad, the
// outputs' strides, the alignment checks) and calls the kernel's extern "C"
// entry in the library ops/kernels/build.py built from csrc/, opened by the
// path native/build.py compiles in. Every launch goes on the current CUDA
// stream (AOTInductor sets it to the package's stream around its calls).
//
// The backward ops (flash_bwd_dq, flash_bwd_dkv) are not registered: no
// inference package holds them.
//
// Never load this library into a process that imported the Python ops
// (deeplearning_tpu_torch.ops): both define dltpu::*.
//
// Counters: dltpu_launches(op) counts the op's kernel launches (bumped right
// after a launch that returned 0, nowhere else); dltpu_plain_runs(op) counts
// the runs of its CPU impl. Both return -1 for an op this library lacks.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <cstring>
#include <limits>
#include <initializer_list>
#include <tuple>

#ifdef DLTPU_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <dlfcn.h>

#include <mutex>
#include <string>
#include <unordered_map>
#endif

namespace {

enum Op { kFlashFwd = 0, kWindowAttn = 1, kNmsSweep = 2, kOps = 3 };
const char* const kOpNames[kOps] = {"flash_fwd", "window_attn", "nms_sweep"};
std::atomic<long> g_launches[kOps];
std::atomic<long> g_plain_runs[kOps];

int op_index(const char* op) {
  for (int i = 0; i < kOps; ++i)
    if (op && std::strcmp(op, kOpNames[i]) == 0) return i;
  return -1;
}

// the head dim a d runs at: the smallest of `dims` (ascending) that holds it;
// above the largest, d rounded up to a multiple of 64 (ops/kernels
// kernel_head_dim, WIDE_GRANULE)
int64_t kernel_head_dim(int64_t d, std::initializer_list<int64_t> dims,
                        const char* name) {
  TORCH_CHECK_VALUE(d >= 1, name, " takes head dims of 1 or more, got ", d);
  for (int64_t dk : dims)
    if (d <= dk) return dk;
  return (d + 63) / 64 * 64;
}

at::ScalarType compute_dtype(const at::Tensor& x) {
  return x.scalar_type() == at::kDouble ? at::kDouble : at::kFloat;
}

// ---------------------------------------------------------------- K1 forward
void check_qkv(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v) {
  TORCH_CHECK_VALUE(q.dim() == 4 && q.sizes() == k.sizes() &&
                        q.sizes() == v.sizes(),
                    "q, k, v must share one (B, H, N, D) shape; got ",
                    q.sizes(), ", ", k.sizes(), ", ", v.sizes());
  TORCH_CHECK_VALUE(q.device() == k.device() && q.device() == v.device(),
                    "q, k, v must lie on one device");
  TORCH_CHECK_VALUE(q.scalar_type() == k.scalar_type() &&
                        q.scalar_type() == v.scalar_type(),
                    "q, k, v must share one dtype");
}

// a (B, H, N, D) result; bnhd: a view of a contiguous (B, N, H, D) tensor
// (flash_attention._empty_bhnd, which lays out the fake results too)
at::Tensor empty_bhnd(const at::Tensor& like, at::ScalarType dtype,
                      bool bnhd) {
  const auto b = like.size(0), h = like.size(1), n = like.size(2),
             d = like.size(3);
  const auto opts = like.options().dtype(dtype);
  if (bnhd) return at::empty({b, n, h, d}, opts).transpose(1, 2);
  return at::empty({b, h, n, d}, opts);
}

at::Tensor rows(const at::Tensor& q) {
  return at::empty({q.size(0), q.size(1), q.size(2)},
                   q.options().dtype(compute_dtype(q)));
}

// flash_attention_reference: softmax(Q K^T * scale, causal mask) V and the
// row log-sum-exp, in float32 (float64 for float64 inputs)
std::tuple<at::Tensor, at::Tensor> flash_reference(const at::Tensor& q,
                                                   const at::Tensor& k,
                                                   const at::Tensor& v,
                                                   double scale, bool causal) {
  const auto n = q.size(2);
  const auto ct = compute_dtype(q);
  auto s = at::einsum("bhqd,bhkd->bhqk", {q.to(ct), k.to(ct)}) * scale;
  if (causal) {
    const auto keep =
        at::ones({n, n}, q.options().dtype(at::kBool)).tril();
    s = s.masked_fill(keep.logical_not(),
                      -std::numeric_limits<double>::infinity());
  }
  auto lse = at::logsumexp(s, {-1});
  auto p = at::exp(s - lse.unsqueeze(-1));
  auto out = at::einsum("bhqk,bhkd->bhqd", {p, v.to(ct)});
  return {out.to(q.scalar_type()), lse};
}

std::tuple<at::Tensor, at::Tensor> flash_fwd_cpu(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    double sm_scale, bool causal, int64_t heads_per_cta, bool bnhd) {
  (void)heads_per_cta;
  check_qkv(q, k, v);
  auto out = empty_bhnd(q, q.scalar_type(), bnhd);
  auto lse = rows(q);
  auto ref = flash_reference(q, k, v, sm_scale, causal);
  out.copy_(std::get<0>(ref));
  lse.copy_(std::get<1>(ref));
  ++g_plain_runs[kFlashFwd];
  return {out, lse};
}

// ---------------------------------------------------------------------- K2
void check_window_args(const at::Tensor& qkv, const at::Tensor& bias,
                       const c10::optional<at::Tensor>& mask) {
  TORCH_CHECK_VALUE(qkv.dim() == 5 && qkv.size(2) == 3,
                    "qkv must be (BW, N, 3, heads, d), got ", qkv.sizes());
  const auto bw = qkv.size(0), n = qkv.size(1), heads = qkv.size(3);
  TORCH_CHECK_VALUE(bias.dim() == 3 && bias.size(0) == heads &&
                        bias.size(1) == n && bias.size(2) == n,
                    "bias must be (heads, N, N) = (", heads, ", ", n, ", ", n,
                    "), got ", bias.sizes());
  TORCH_CHECK_VALUE(bias.device() == qkv.device(),
                    "qkv, bias and mask must lie on one device");
  if (mask.has_value()) {
    const auto& m = *mask;
    TORCH_CHECK_VALUE(m.dim() == 3 && m.size(1) == n && m.size(2) == n &&
                          m.size(0) > 0 && bw % m.size(0) == 0,
                      "mask must be (nW, N, N) with nW dividing BW=", bw,
                      ", got ", m.sizes());
    TORCH_CHECK_VALUE(m.device() == qkv.device(),
                      "qkv, bias and mask must lie on one device");
  }
}

// window_attention_plain: S = Q K^T * d^-1/2 + bias + mask[w mod nW] in
// float32, softmax, P cast to v's dtype, P V in float32
at::Tensor window_plain(const at::Tensor& qkv, const at::Tensor& bias,
                        const c10::optional<at::Tensor>& mask) {
  const auto bw = qkv.size(0), n = qkv.size(1), heads = qkv.size(3),
             d = qkv.size(4);
  const double scale = std::pow(static_cast<double>(d), -0.5);
  const auto ct = qkv.scalar_type() == at::kDouble ? at::kDouble : at::kFloat;
  auto parts = qkv.unbind(2);
  const auto &q = parts[0], &k = parts[1], &v = parts[2];
  auto s = at::einsum("bqhd,bkhd->bhqk", {q.to(ct), k.to(ct)}) * scale;
  s = s + bias.to(ct).unsqueeze(0);
  if (mask.has_value()) {
    const auto nw = mask->size(0);
    s = s.reshape({bw / nw, nw, heads, n, n}) +
        mask->to(ct).unsqueeze(0).unsqueeze(2);
    s = s.reshape({bw, heads, n, n});
  }
  auto p = at::softmax(s, -1).to(v.scalar_type()).to(ct);
  auto out = at::einsum("bhqk,bkhd->bqhd", {p, v.to(ct)});
  return out.reshape({bw, n, heads * d}).to(qkv.scalar_type());
}

at::Tensor window_attn_cpu(const at::Tensor& qkv, const at::Tensor& bias,
                           const c10::optional<at::Tensor>& mask,
                           int64_t windows_per_block) {
  (void)windows_per_block;
  check_window_args(qkv, bias, mask);
  auto out = window_plain(qkv, bias, mask).contiguous();
  ++g_plain_runs[kWindowAttn];
  return out;
}

// ---------------------------------------------------------------------- K3
constexpr int64_t kWord = 64;          // nms.WORD: K3's candidate block
constexpr int64_t kKeptSmem = 10240;   // nms.KEPT_SMEM

void check_sweep_args(const at::Tensor& sboxes, const at::Tensor& alive0) {
  TORCH_CHECK_VALUE(sboxes.dim() == 3 && sboxes.size(2) == 4 &&
                        alive0.dim() == 2 && alive0.size(0) == sboxes.size(0) &&
                        alive0.size(1) == sboxes.size(1),
                    "sboxes must be (B, Npad, 4) with alive0 (B, Npad), got ",
                    sboxes.sizes(), " and ", alive0.sizes());
  TORCH_CHECK_VALUE(sboxes.device() == alive0.device(),
                    "sboxes and alive0 must lie on one device");
  TORCH_CHECK_VALUE(alive0.scalar_type() == at::kBool,
                    "alive0 must be bool, got ", alive0.scalar_type());
  TORCH_CHECK_VALUE(sboxes.size(1) % kWord == 0,
                    "the NMS kernel takes candidates padded to a multiple of ",
                    kWord, ", got ", sboxes.size(1));
}

at::Tensor box_area(const at::Tensor& b) {
  return (b.select(-1, 2) - b.select(-1, 0)).clamp_min(0) *
         (b.select(-1, 3) - b.select(-1, 1)).clamp_min(0);
}

// ops/boxes.box_iou: (..., N, 4) x (..., M, 4) -> (..., N, M)
at::Tensor box_iou(const at::Tensor& b1, const at::Tensor& b2) {
  auto area1 = box_area(b1);
  auto area2 = box_area(b2);
  auto lt = at::maximum(b1.slice(-1, 0, 2).unsqueeze(-2),
                        b2.slice(-1, 0, 2).unsqueeze(-3));
  auto rb = at::minimum(b1.slice(-1, 2, 4).unsqueeze(-2),
                        b2.slice(-1, 2, 4).unsqueeze(-3));
  auto wh = (rb - lt).clamp_min(0);
  auto inter = wh.select(-1, 0) * wh.select(-1, 1);
  auto uni = area1.unsqueeze(-1) + area2.unsqueeze(-2) - inter;
  return inter / uni.clamp_min(1e-9);
}

// nms._intra_block_keep: the fixed point of
// A <- alive0 & !(exists j < k: A[j] & IoU(j, k) > th)
at::Tensor intra_block_keep(const at::Tensor& blk, const at::Tensor& alive,
                            double th) {
  const auto block = blk.size(1);
  auto pos = at::arange(block, blk.options().dtype(at::kLong));
  auto sup_in = (box_iou(blk, blk) > th) &
                (pos.unsqueeze(1) < pos.unsqueeze(0));
  auto keep = alive;
  while (true) {
    auto next = alive & (sup_in & keep.unsqueeze(2)).any(1).logical_not();
    if (at::equal(next, keep)) return keep;
    keep = next;
  }
}

// nms_sweep_plain in 64-wide blocks (the Python op's CPU path)
at::Tensor sweep_plain(const at::Tensor& sboxes, const at::Tensor& alive0,
                       double th, int64_t max_out) {
  const auto b = alive0.size(0), npad = alive0.size(1);
  const auto nb = npad / kWord;
  auto col = at::arange(npad, alive0.options().dtype(at::kLong));
  auto alive = alive0.clone();
  auto kept = at::zeros({b}, alive0.options().dtype(at::kLong));
  for (int64_t i = 0; i < nb; ++i) {
    auto going = kept < max_out;
    if (!going.any().item<bool>()) break;
    const auto start = i * kWord;
    auto blk = sboxes.slice(1, start, start + kWord);
    auto keep = intra_block_keep(blk, alive.slice(1, start, start + kWord), th);
    auto hit = ((box_iou(blk, sboxes) > th) & keep.unsqueeze(2)).any(1);
    auto next = alive & (hit & (col >= start + kWord)).logical_not();
    next.slice(1, start, start + kWord).copy_(keep);
    alive = at::where(going.unsqueeze(1), next, alive);
    kept = kept + at::where(going, keep.to(at::kLong).sum(1),
                            at::zeros_like(kept));
  }
  return alive;
}

at::Tensor nms_sweep_cpu(const at::Tensor& sboxes, const at::Tensor& alive0,
                         double iou_threshold, int64_t max_out) {
  check_sweep_args(sboxes, alive0);
  auto out = sweep_plain(sboxes, alive0, iou_threshold, max_out);
  ++g_plain_runs[kNmsSweep];
  return out;
}

#ifdef DLTPU_WITH_CUDA
// ------------------------------------------------------------ the card half
// the kernel libraries' paths, compiled in by native/build.py
#ifndef DLTPU_FLASH_ATTN_FWD_LIB
#error "DLTPU_FLASH_ATTN_FWD_LIB (the path of libflash_attn_fwd) is not set"
#endif
#ifndef DLTPU_WINDOW_ATTN_FWD_LIB
#error "DLTPU_WINDOW_ATTN_FWD_LIB (the path of libwindow_attn_fwd) is not set"
#endif
#ifndef DLTPU_NMS_SWEEP_LIB
#error "DLTPU_NMS_SWEEP_LIB (the path of libnms_sweep) is not set"
#endif

using ErrorStringFn = const char* (*)(int);
using FlashFwdFn = int (*)(const void*, const void*, const void*, void*, void*,
                           int, int, int, int, long long, long long, long long,
                           long long, long long, long long, long long,
                           long long, long long, long long, long long,
                           long long, float, int, int, int, void*);
using WindowFwdFn = int (*)(const void*, const void*, const void*, void*, int,
                            int, int, int, int, int, long long, long long,
                            long long, long long, long long, long long, float,
                            int, void*);
using NmsSweepFn = int (*)(const void*, const void*, const void*, void*, void*,
                           int, int, int, int, float, void*);

// dlsym of `symbol` in the library at `path`, opened once a process
void* kernel_symbol(const char* path, const char* symbol) {
  static std::mutex mu;
  static std::unordered_map<std::string, void*> handles;
  std::lock_guard<std::mutex> lock(mu);
  void*& handle = handles[path];
  if (!handle) {
    handle = dlopen(path, RTLD_NOW | RTLD_LOCAL);
    TORCH_CHECK(handle, "cannot open the kernel library ", path, ": ",
                dlerror());
  }
  void* fn = dlsym(handle, symbol);
  TORCH_CHECK(fn, "no symbol ", symbol, " in ", path);
  return fn;
}

void check_card(const at::Device& device, const char* what) {
  const int index =
      device.has_index() ? device.index() : c10::cuda::current_device();
  int major = 0, minor = 0;
  cudaDeviceGetAttribute(&major, cudaDevAttrComputeCapabilityMajor, index);
  cudaDeviceGetAttribute(&minor, cudaDevAttrComputeCapabilityMinor, index);
  TORCH_CHECK(major >= 9, "the ", what,
              " kernels are built for sm_90a (Hopper); device ", index,
              " is sm_", major, minor);
}

int dtype_code(const at::Tensor& x, const char* name) {
  if (x.scalar_type() == at::kFloat) return 0;
  if (x.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK_VALUE(false, name, " takes float32 or bfloat16, got ",
                    x.scalar_type());
  return -1;
}

void* current_stream(const at::Tensor& x) {
  return c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
}

// the kernels move 16-byte vectors: base and the first `dims` strides must be
// 16-byte multiples with a contiguous last dim, else a fresh copy
bool is_aligned(const at::Tensor& x, int dims) {
  const int64_t vec = 16 / x.element_size();
  if (x.stride(-1) != 1 ||
      reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 != 0)
    return false;
  for (int i = 0; i < dims; ++i)
    if (x.stride(i) % vec != 0) return false;
  return true;
}

at::Tensor aligned(const at::Tensor& x, int dims) {
  return is_aligned(x, dims) ? x : x.clone(at::MemoryFormat::Contiguous);
}

constexpr std::initializer_list<int64_t> kFlashHeadDims = {16, 32, 64, 128,
                                                           256};

// flash_attention._launch: q, k, v, out (B, H, N, D) at an instantiated D;
// lse a contiguous float32 (B, H, N)
void flash_launch(at::Tensor q, at::Tensor k, at::Tensor v, at::Tensor& out,
                  at::Tensor& lse, double scale, bool causal,
                  int64_t heads_per_cta) {
  const auto b = q.size(0), h = q.size(1), n = q.size(2), d = q.size(3);
  check_card(q.device(), "flash-attention");
  TORCH_CHECK_VALUE(kernel_head_dim(d, kFlashHeadDims, "flash_attn") == d,
                    "flash_attn_fwd takes head dim in (16, 32, 64, 128, 256) "
                    "or a multiple of 64 above, got ", d);
  const int code = dtype_code(q, "flash_attn_fwd");
  TORCH_CHECK_VALUE((heads_per_cta == 1 || heads_per_cta == 2 ||
                     heads_per_cta == 4) && h % heads_per_cta == 0,
                    "heads_per_cta=", heads_per_cta,
                    " must be in (1, 2, 4) and divide H=", h);
  q = aligned(q, 3);
  k = aligned(k, 3);
  v = aligned(v, 3);
  TORCH_CHECK_VALUE(is_aligned(out, 3),
                    "output view must be 16-byte aligned with a contiguous "
                    "last dim");
  TORCH_CHECK_VALUE(lse.scalar_type() == at::kFloat && lse.is_contiguous() &&
                        lse.numel() == b * h * n,
                    "lse must be a contiguous float32 buffer of B*H*N");
  static auto fn = reinterpret_cast<FlashFwdFn>(
      kernel_symbol(DLTPU_FLASH_ATTN_FWD_LIB, "flash_attn_fwd"));
  static auto err = reinterpret_cast<ErrorStringFn>(
      kernel_symbol(DLTPU_FLASH_ATTN_FWD_LIB, "flash_attn_error_string"));
  c10::cuda::CUDAGuard guard(q.device());
  const int rc =
      fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         lse.data_ptr(), int(b), int(h), int(n), int(d), q.stride(0),
         q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
         v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
         out.stride(2), float(scale), int(causal), int(heads_per_cta), code,
         current_stream(q));
  TORCH_CHECK(rc == 0, "flash_attn_fwd launch failed (", rc, "): ", err(rc));
  ++g_launches[kFlashFwd];
}

// flash_attention._fwd_into on the card: D zero-padded to the kernel's head
// dim with the scale of the true D, the output sliced back
void flash_fwd_into(const at::Tensor& q, const at::Tensor& k,
                    const at::Tensor& v, at::Tensor& out, at::Tensor& lse,
                    double scale, bool causal, int64_t heads_per_cta) {
  const auto d = q.size(3);
  const auto dk = kernel_head_dim(d, kFlashHeadDims, "flash_attn");
  if (dk != d) {
    auto qp = at::constant_pad_nd(q, {0, dk - d});
    auto kp = at::constant_pad_nd(k, {0, dk - d});
    auto vp = at::constant_pad_nd(v, {0, dk - d});
    auto o = at::empty_like(qp, at::MemoryFormat::Contiguous);
    flash_fwd_into(qp, kp, vp, o, lse, scale, causal, heads_per_cta);
    out.copy_(o.slice(-1, 0, d));
    return;
  }
  if (q.size(2) == 0 || q.size(0) * q.size(1) == 0) return;
  flash_launch(q, k, v, out, lse, scale, causal, heads_per_cta);
}

std::tuple<at::Tensor, at::Tensor> flash_fwd_cuda(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    double sm_scale, bool causal, int64_t heads_per_cta, bool bnhd) {
  check_qkv(q, k, v);
  auto out = empty_bhnd(q, q.scalar_type(), bnhd);
  auto lse = rows(q);
  flash_fwd_into(q, k, v, out, lse, sm_scale, causal, heads_per_cta);
  return {out, lse};
}

constexpr std::initializer_list<int64_t> kWindowHeadDims = {16, 32, 64, 128};

// window_attention._launch_kernel at an instantiated d
at::Tensor window_launch(at::Tensor qkv, const at::Tensor& bias_in,
                         const c10::optional<at::Tensor>& mask_in,
                         int64_t wpb, double scale) {
  const auto bw = qkv.size(0), n = qkv.size(1), heads = qkv.size(3),
             d = qkv.size(4);
  qkv = aligned(qkv, 4);
  auto bias = bias_in.to(at::kFloat).contiguous();
  at::Tensor mask;
  int64_t nw = 1;
  if (mask_in.has_value()) {
    mask = mask_in->to(at::kFloat).contiguous();
    nw = mask.size(0);
  }
  auto out = at::empty({bw, n, heads * d}, qkv.options());
  if (bw == 0) return out;
  static auto fn = reinterpret_cast<WindowFwdFn>(
      kernel_symbol(DLTPU_WINDOW_ATTN_FWD_LIB, "window_attn_fwd"));
  static auto err = reinterpret_cast<ErrorStringFn>(
      kernel_symbol(DLTPU_WINDOW_ATTN_FWD_LIB, "window_attn_error_string"));
  c10::cuda::CUDAGuard guard(qkv.device());
  const int rc = fn(qkv.data_ptr(), bias.data_ptr(),
                    mask.defined() ? mask.data_ptr() : nullptr,
                    out.data_ptr(), int(bw), int(n), int(heads), int(d),
                    int(nw), int(wpb), qkv.stride(0), qkv.stride(1),
                    qkv.stride(2), qkv.stride(3), out.stride(0), out.stride(1),
                    float(scale), dtype_code(qkv, "window_attn_fwd"),
                    current_stream(qkv));
  TORCH_CHECK(rc == 0, "window_attn_fwd launch failed (", rc, "): ", err(rc));
  ++g_launches[kWindowAttn];
  return out;
}

at::Tensor window_attn_cuda(const at::Tensor& qkv, const at::Tensor& bias,
                            const c10::optional<at::Tensor>& mask,
                            int64_t windows_per_block) {
  check_window_args(qkv, bias, mask);
  dtype_code(qkv, "window_attn_fwd");
  check_card(qkv.device(), "window-attention");
  const int64_t wpb = windows_per_block > 1 ? windows_per_block : 1;
  const auto bw = qkv.size(0), n = qkv.size(1), heads = qkv.size(3),
             d = qkv.size(4);
  const auto dk = kernel_head_dim(d, kWindowHeadDims, "window_attn_fwd");
  const double scale = std::pow(static_cast<double>(d), -0.5);
  if (dk == d) return window_launch(qkv, bias, mask, wpb, scale);
  auto out = window_launch(at::constant_pad_nd(qkv, {0, dk - d}), bias, mask,
                           wpb, scale);
  return out.view({bw, n, heads, dk}).slice(-1, 0, d).reshape(
      {bw, n, heads * d});
}

at::Tensor nms_sweep_cuda(const at::Tensor& sboxes_in,
                          const at::Tensor& alive0_in, double iou_threshold,
                          int64_t max_out) {
  check_sweep_args(sboxes_in, alive0_in);
  check_card(sboxes_in.device(), "NMS");
  TORCH_CHECK_VALUE(sboxes_in.scalar_type() == at::kFloat,
                    "the NMS kernel takes float32 boxes, got ",
                    sboxes_in.scalar_type());
  const auto b = alive0_in.size(0), npad = alive0_in.size(1);
  auto out = at::empty({b, npad}, alive0_in.options());
  if (b == 0 || max_out <= 0) return out.zero_();
  auto sboxes = sboxes_in.contiguous();
  if (reinterpret_cast<uintptr_t>(sboxes.data_ptr()) % 16 != 0)
    sboxes = sboxes.clone();
  auto alive0 = alive0_in.contiguous();
  // one past the last live candidate of each image: the walk stops there
  auto pos = at::arange(1, npad + 1, alive0.options().dtype(at::kInt));
  auto n_live = at::where(alive0, pos, at::zeros_like(pos))
                    .amax({1})
                    .to(at::kInt)
                    .contiguous();
  const int64_t most = max_out < npad ? max_out : npad;
  const int64_t spill_cap = most - kKeptSmem > 0 ? most - kKeptSmem : 0;
  at::Tensor spill;
  if (spill_cap)
    spill = at::empty({b, spill_cap, 4}, sboxes.options());
  static auto fn = reinterpret_cast<NmsSweepFn>(
      kernel_symbol(DLTPU_NMS_SWEEP_LIB, "nms_greedy_sweep"));
  static auto err = reinterpret_cast<ErrorStringFn>(
      kernel_symbol(DLTPU_NMS_SWEEP_LIB, "nms_error_string"));
  c10::cuda::CUDAGuard guard(alive0.device());
  const int rc = fn(sboxes.data_ptr(), alive0.data_ptr(), n_live.data_ptr(),
                    spill.defined() ? spill.data_ptr() : nullptr,
                    out.data_ptr(), int(b), int(npad), int(spill_cap),
                    int(max_out), static_cast<float>(iou_threshold),
                    current_stream(alive0));
  TORCH_CHECK(rc == 0, "nms_greedy_sweep launch failed (", rc, "): ",
              err(rc));
  ++g_launches[kNmsSweep];
  return out;
}
#endif  // DLTPU_WITH_CUDA

}  // namespace

TORCH_LIBRARY(dltpu, m) {
  m.def(
      "flash_fwd(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal, "
      "int heads_per_cta, bool bnhd) -> (Tensor, Tensor)");
  m.def(
      "window_attn(Tensor qkv, Tensor bias, Tensor? mask, "
      "int windows_per_block) -> Tensor");
  m.def(
      "nms_sweep(Tensor sboxes, Tensor alive0, float iou_threshold, "
      "int max_out) -> Tensor");
}

TORCH_LIBRARY_IMPL(dltpu, CPU, m) {
  m.impl("flash_fwd", &flash_fwd_cpu);
  m.impl("window_attn", &window_attn_cpu);
  m.impl("nms_sweep", &nms_sweep_cpu);
}

#ifdef DLTPU_WITH_CUDA
TORCH_LIBRARY_IMPL(dltpu, CUDA, m) {
  m.impl("flash_fwd", &flash_fwd_cuda);
  m.impl("window_attn", &window_attn_cuda);
  m.impl("nms_sweep", &nms_sweep_cuda);
}
#endif

extern "C" {

long dltpu_launches(const char* op) {
  const int i = op_index(op);
  return i < 0 ? -1 : g_launches[i].load();
}

long dltpu_plain_runs(const char* op) {
  const int i = op_index(op);
  return i < 0 ? -1 : g_plain_runs[i].load();
}

}  // extern "C"
