// Python binding of the CUDA kernels' plain C interface.
//
// Pointers and the stream arrive as integers from the Python wrappers
// (drawingspinup_torch/kernels/ric_conv.py), which check device, dtype,
// shape and contiguity and allocate the outputs first. The binding uses no
// ATen API, so it includes pybind11 alone (shipped with torch's headers);
// the full torch/extension.h would add minutes of compile time to every
// fresh build.
#include <pybind11/pybind11.h>

#include <cstdint>
#include <string>

extern "C" int ric_conv_fwd_launch(const float* x, const float* wk,
                                   const float* swf, float* out, int n, int h,
                                   int w, int c, int o, void* stream);
extern "C" int ric_conv_bwd_dx_launch(const float* g, const float* wk,
                                      const float* swf, float* dx, int n,
                                      int h, int w, int c, int o,
                                      void* stream);
extern "C" int ric_conv_bwd_dwk_launch(const float* x, const float* g,
                                       const float* swf, float* dz,
                                       float* scratch, float* dwk, int n,
                                       int h, int w, int c, int o, int slices,
                                       void* stream);
extern "C" const char* ric_conv_error_string(int err);

namespace {

template <typename T>
T* ptr(std::uintptr_t address) {
  return reinterpret_cast<T*>(address);
}

int ric_conv_fwd(std::uintptr_t x, std::uintptr_t wk, std::uintptr_t swf,
                 std::uintptr_t out, int n, int h, int w, int c, int o,
                 std::uintptr_t stream) {
  return ric_conv_fwd_launch(ptr<const float>(x), ptr<const float>(wk),
                             ptr<const float>(swf), ptr<float>(out), n, h, w,
                             c, o, ptr<void>(stream));
}

int ric_conv_bwd_dx(std::uintptr_t g, std::uintptr_t wk, std::uintptr_t swf,
                    std::uintptr_t dx, int n, int h, int w, int c, int o,
                    std::uintptr_t stream) {
  return ric_conv_bwd_dx_launch(ptr<const float>(g), ptr<const float>(wk),
                                ptr<const float>(swf), ptr<float>(dx), n, h,
                                w, c, o, ptr<void>(stream));
}

int ric_conv_bwd_dwk(std::uintptr_t x, std::uintptr_t g, std::uintptr_t swf,
                     std::uintptr_t dz, std::uintptr_t scratch,
                     std::uintptr_t dwk, int n, int h, int w, int c, int o,
                     int slices, std::uintptr_t stream) {
  return ric_conv_bwd_dwk_launch(ptr<const float>(x), ptr<const float>(g),
                                 ptr<const float>(swf), ptr<float>(dz),
                                 ptr<float>(scratch), ptr<float>(dwk), n, h,
                                 w, c, o, slices, ptr<void>(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("ric_conv_fwd", &ric_conv_fwd,
        "Launch the RIC conv forward kernel; returns the cudaError_t code.");
  m.def("ric_conv_bwd_dx", &ric_conv_bwd_dx,
        "Launch the RIC conv backward dx kernel; returns the cudaError_t code.");
  m.def("ric_conv_bwd_dwk", &ric_conv_bwd_dwk,
        "Launch the RIC conv backward dwk kernels (sampled cotangent, "
        "split-K partial products, their ordered reduction); returns the "
        "cudaError_t code.");
  m.def("error_string",
        [](int err) { return std::string(ric_conv_error_string(err)); },
        "cudaGetErrorString of a launch's return code.");
}
