// The custom-op demo: the counterpart of the JAX package's
// native/my_add.cc, which is the TPU-era form of the reference's custom-op
// tutorial (others/deploy/pytorch2onnx/my_add.cpp:5-12: `3a + 2b`
// registered as a torch extension and exported to ONNX). Here the same
// toy op is a plain C ABI function, built with g++ by native/build.py,
// loaded through ctypes and registered as the torch.library custom op
// dltpu::my_add with a fake implementation (export/custom_op.py), so it
// runs eagerly and shows as one node in a torch.export graph.

#include <cstdint>

extern "C" void my_add(const float* a, const float* b, float* out,
                       int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = 3.0f * a[i] + 2.0f * b[i];
}
