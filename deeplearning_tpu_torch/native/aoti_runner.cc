// Native C++ inference runner over libtorch's AOTInductor package loader:
// the counterpart of the JAX package's native/savedmodel_runner.cc (the
// TPU-era successor of the reference's C++ deployment demos,
// others/deploy/onnx2trt/inference_trt.cpp:105). It loads the package
// export/serialize.py export_savedmodel writes (torch.export, then
// torch._inductor.aoti_compile_and_package), feeds one float32 NHWC tensor,
// runs it and prints the first output. No Python runs in this process.
//
//   aoti_runner <package.pt2> <libdltpu_ops.so | -> d0,d1,... [iters [out]]
//
// The op library (native/dltpu_ops.cpp) is opened with RTLD_NOW |
// RTLD_GLOBAL before the package, so the package's dltpu::* calls find their
// schemas and kernels in the dispatcher; "-" opens none, and a package that
// calls a dltpu op then fails to load, naming it. The input is the same
// deterministic ramp as the JAX runner's, 0.001 * (i % 1000), moved to the
// card when the package was compiled for CUDA. Prints
//   output_shape: d0 d1 ...
//   values: the first 16 values of the output, as %.6f
//   launches: flash_fwd=<n> window_attn=<n> nms_sweep=<n>
// where n counts the op's runs in the library on the package's device (its
// kernel launches on the card, its plain version's runs on the CPU). With
// iters > 0 it then times that many runs after 3 warm-up runs, on the host's
// clock, ending in a copy of the output to the host (which waits for the
// stream), and prints "forward_ms: <mean ms a run>". Given a path <out>, it
// also writes the whole first output there, float32 in row-major order with
// no header, so a caller can hold every value, not only the first 16.
//
// Built by native/build.py (build_serving()) against the installed torch:
//   g++ -std=c++17 -D_GLIBCXX_USE_CXX11_ABI=<torch's> -I<torch>/include
//       aoti_runner.cc -L<torch>/lib -ltorch -ltorch_cpu -lc10
//       [-ltorch_cuda -lc10_cuda] -ldl -Wl,-rpath,<torch>/lib

#include <ATen/ATen.h>
#include <c10/util/Exception.h>
#include <dlfcn.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

using CounterFn = long (*)(const char*);

std::vector<int64_t> parse_dims(const char* spec) {
  std::vector<int64_t> dims;
  std::string s(spec);
  size_t start = 0;
  while (start <= s.size()) {
    const size_t end = s.find(',', start);
    const std::string tok =
        s.substr(start, end == std::string::npos ? std::string::npos
                                                 : end - start);
    if (!tok.empty()) dims.push_back(std::atoll(tok.c_str()));
    if (end == std::string::npos) break;
    start = end + 1;
  }
  return dims;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s <package.pt2> <libdltpu_ops.so | -> "
                 "d0,d1,d2,... [iters [out]]\n",
                 argv[0]);
    return 2;
  }
  const char* package = argv[1];
  const char* ops_path = argv[2];
  const std::vector<int64_t> dims = parse_dims(argv[3]);
  const int iters = argc > 4 ? std::atoi(argv[4]) : 0;
  const char* out_path = argc > 5 ? argv[5] : nullptr;
  if (dims.empty()) {
    std::fprintf(stderr, "no input dims in %s\n", argv[3]);
    return 2;
  }

  void* ops = nullptr;
  if (std::strcmp(ops_path, "-") != 0) {
    ops = dlopen(ops_path, RTLD_NOW | RTLD_GLOBAL);
    if (!ops) {
      std::fprintf(stderr, "cannot load the op library %s: %s\n", ops_path,
                   dlerror());
      return 1;
    }
  }

  try {
    torch::inductor::AOTIModelPackageLoader loader(package);
    const auto meta = loader.get_metadata();
    const auto found = meta.find("AOTI_DEVICE_KEY");
    const std::string device =
        found == meta.end() ? std::string("cpu") : found->second;
    const bool cuda = device.rfind("cuda", 0) == 0;

    // deterministic ramp input, so a Python run can cross-check exactly
    at::Tensor x = at::empty(dims, at::TensorOptions().dtype(at::kFloat));
    float* data = x.data_ptr<float>();
    for (int64_t i = 0; i < x.numel(); ++i)
      data[i] = 0.001f * static_cast<float>(i % 1000);
    if (cuda) x = x.to(at::Device(at::kCUDA, 0));

    std::vector<at::Tensor> outs = loader.run({x});
    if (outs.empty()) {
      std::fprintf(stderr, "the package returned no output\n");
      return 1;
    }
    const at::Tensor out =
        outs[0].to(at::kCPU).to(at::kFloat).contiguous();
    std::printf("output_shape:");
    for (int64_t d : out.sizes()) std::printf(" %lld", (long long)d);
    std::printf("\nvalues:");
    const float* vals = out.data_ptr<float>();
    for (int64_t i = 0; i < out.numel() && i < 16; ++i)
      std::printf(" %.6f", vals[i]);
    std::printf("\n");
    if (out_path) {
      FILE* f = std::fopen(out_path, "wb");
      const size_t n = static_cast<size_t>(out.numel());
      if (!f || std::fwrite(vals, sizeof(float), n, f) != n ||
          std::fclose(f) != 0) {
        std::fprintf(stderr, "cannot write the output to %s\n", out_path);
        return 1;
      }
    }

    std::printf("launches:");
    const char* names[] = {"flash_fwd", "window_attn", "nms_sweep"};
    CounterFn count = nullptr;
    if (ops)
      count = reinterpret_cast<CounterFn>(
          dlsym(ops, cuda ? "dltpu_launches" : "dltpu_plain_runs"));
    for (const char* name : names)
      std::printf(" %s=%ld", name, count ? count(name) : 0L);
    std::printf("\n");

    if (iters > 0) {
      for (int i = 0; i < 3; ++i) outs = loader.run({x});
      (void)outs[0].to(at::kCPU);
      const auto t0 = std::chrono::steady_clock::now();
      for (int i = 0; i < iters; ++i) outs = loader.run({x});
      (void)outs[0].to(at::kCPU);
      const double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
      std::printf("forward_ms: %.4f\n", ms / iters);
    }
    std::fflush(stdout);
  } catch (const c10::Error& e) {
    std::fflush(stdout);
    std::fprintf(stderr, "aoti_runner: %s\n", e.what_without_backtrace());
    return 1;
  } catch (const std::exception& e) {
    std::fflush(stdout);
    std::fprintf(stderr, "aoti_runner: %s\n", e.what());
    return 1;
  }
  return 0;
}
