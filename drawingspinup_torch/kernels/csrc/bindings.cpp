// Python binding of the CUDA kernels' plain C interface.
//
// Pointers and the stream arrive as integers from the Python wrappers
// (drawingspinup_torch/kernels/ric_conv.py and hashgrid.py), which check
// device, dtype, shape and contiguity and allocate the outputs first. The
// binding uses no ATen API, so it includes pybind11 alone (shipped with
// torch's headers); the full torch/extension.h would add minutes of compile
// time to every fresh build.
#include <pybind11/pybind11.h>
#include <pybind11/stl.h>

#include <cstdint>
#include <string>
#include <vector>

extern "C" int ric_conv_fwd_launch(const float* x, const float* wk,
                                   const float* swf, float* wsplit,
                                   float* part, float* out, int n, int h,
                                   int w, int c, int o, int bn, int ck,
                                   int slice_stages, int slices,
                                   void* stream);
extern "C" int ric_conv_bwd_dz_launch(const float* g, const float* swf,
                                      float* dz, int n, int h, int w, int o,
                                      void* stream);
extern "C" int ric_conv_bwd_gemm_launch(const float* a, int a_kmajor,
                                        const float* b, float* part, int m,
                                        int n, int k, int slice_k,
                                        int slices, int bm, int bn, int bk,
                                        void* stream);
extern "C" int ric_conv_bwd_dwk_reduce_launch(const float* part, float* dwk,
                                              int c, int o, int slices,
                                              void* stream);
extern "C" int ric_conv_bwd_sum_slices_launch(const float* part, float* out,
                                              long long elems, int slices,
                                              void* stream);
extern "C" const char* ric_conv_error_string(int err);
extern "C" int hashgrid_fwd_launch(const float* x, long long P, int n_active,
                                   const void* const* tables, const int* res,
                                   const int* dense, int table_size, int F,
                                   int cell_rows, int tab_bf16, int cdt_bf16,
                                   int stride, void* enc, void* denc,
                                   void* stream);
extern "C" int hashgrid_bwd_terms_launch(const float* x, long long P,
                                         int n_active, const int* res,
                                         const int* dense,
                                         const long long* row_base,
                                         int table_size, int F, int cell_rows,
                                         int cdt_bf16, int stride,
                                         const void* g_enc, const void* g_denc,
                                         int* keys, float* terms,
                                         void* stream);
extern "C" int hashgrid_bwd_segsum_launch(const int* sorted_keys,
                                          const long long* order,
                                          const float* terms, long long n,
                                          int F, float* grad, void* stream);
extern "C" int row_gather_launch(const void* tab, long long T, int row_bytes,
                                 const int* idx, long long K, void* out,
                                 void* stream);

namespace {

template <typename T>
T* ptr(std::uintptr_t address) {
  return reinterpret_cast<T*>(address);
}

int ric_conv_fwd(std::uintptr_t x, std::uintptr_t wk, std::uintptr_t swf,
                 std::uintptr_t wsplit, std::uintptr_t part,
                 std::uintptr_t out, int n, int h, int w, int c, int o,
                 int bn, int ck, int slice_stages, int slices,
                 std::uintptr_t stream) {
  return ric_conv_fwd_launch(ptr<const float>(x), ptr<const float>(wk),
                             ptr<const float>(swf), ptr<float>(wsplit),
                             ptr<float>(part), ptr<float>(out), n, h, w, c, o,
                             bn, ck, slice_stages, slices, ptr<void>(stream));
}

int ric_conv_bwd_dz(std::uintptr_t g, std::uintptr_t swf, std::uintptr_t dz,
                    int n, int h, int w, int o, std::uintptr_t stream) {
  return ric_conv_bwd_dz_launch(ptr<const float>(g), ptr<const float>(swf),
                                ptr<float>(dz), n, h, w, o, ptr<void>(stream));
}

int ric_conv_bwd_gemm(std::uintptr_t a, int a_kmajor, std::uintptr_t b,
                      std::uintptr_t part, int m, int n, int k, int slice_k,
                      int slices, int bm, int bn, int bk,
                      std::uintptr_t stream) {
  return ric_conv_bwd_gemm_launch(ptr<const float>(a), a_kmajor,
                                  ptr<const float>(b), ptr<float>(part), m, n,
                                  k, slice_k, slices, bm, bn, bk,
                                  ptr<void>(stream));
}

int ric_conv_bwd_dwk_reduce(std::uintptr_t part, std::uintptr_t dwk, int c,
                            int o, int slices, std::uintptr_t stream) {
  return ric_conv_bwd_dwk_reduce_launch(ptr<const float>(part),
                                        ptr<float>(dwk), c, o, slices,
                                        ptr<void>(stream));
}

int ric_conv_bwd_sum_slices(std::uintptr_t part, std::uintptr_t out,
                            long long elems, int slices,
                            std::uintptr_t stream) {
  return ric_conv_bwd_sum_slices_launch(ptr<const float>(part),
                                        ptr<float>(out), elems, slices,
                                        ptr<void>(stream));
}

int hashgrid_fwd(std::uintptr_t x, long long p,
                 const std::vector<std::uintptr_t>& tables,
                 const std::vector<int>& res, const std::vector<int>& dense,
                 int table_size, int f, int cell_rows, int tab_bf16,
                 int cdt_bf16, int stride, std::uintptr_t enc,
                 std::uintptr_t denc, std::uintptr_t stream) {
  std::vector<const void*> t(tables.size());
  for (size_t i = 0; i < tables.size(); ++i) t[i] = ptr<const void>(tables[i]);
  if (res.size() != t.size() || dense.size() != t.size()) return 1;
  return hashgrid_fwd_launch(ptr<const float>(x), p,
                             static_cast<int>(t.size()), t.data(), res.data(),
                             dense.data(), table_size, f, cell_rows, tab_bf16,
                             cdt_bf16, stride, ptr<void>(enc), ptr<void>(denc),
                             ptr<void>(stream));
}

int hashgrid_bwd_terms(std::uintptr_t x, long long p,
                       const std::vector<int>& res,
                       const std::vector<int>& dense,
                       const std::vector<long long>& row_base, int table_size,
                       int f, int cell_rows, int cdt_bf16, int stride,
                       std::uintptr_t g_enc, std::uintptr_t g_denc,
                       std::uintptr_t keys, std::uintptr_t terms,
                       std::uintptr_t stream) {
  if (res.size() != dense.size() || res.size() != row_base.size()) return 1;
  return hashgrid_bwd_terms_launch(
      ptr<const float>(x), p, static_cast<int>(res.size()), res.data(),
      dense.data(), row_base.data(), table_size, f, cell_rows, cdt_bf16,
      stride, ptr<const void>(g_enc), ptr<const void>(g_denc), ptr<int>(keys),
      ptr<float>(terms), ptr<void>(stream));
}

int hashgrid_bwd_segsum(std::uintptr_t sorted_keys, std::uintptr_t order,
                        std::uintptr_t terms, long long n, int f,
                        std::uintptr_t grad, std::uintptr_t stream) {
  return hashgrid_bwd_segsum_launch(
      ptr<const int>(sorted_keys), ptr<const long long>(order),
      ptr<const float>(terms), n, f, ptr<float>(grad), ptr<void>(stream));
}

int row_gather(std::uintptr_t tab, long long t, int row_bytes,
               std::uintptr_t idx, long long k, std::uintptr_t out,
               std::uintptr_t stream) {
  return row_gather_launch(ptr<const void>(tab), t, row_bytes,
                           ptr<const int>(idx), k, ptr<void>(out),
                           ptr<void>(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("ric_conv_fwd", &ric_conv_fwd,
        "Launch the RIC conv forward (wk split, 3xTF32 implicit GEMM, ordered "
        "sum of its slices); returns the cudaError_t code.");
  m.def("ric_conv_bwd_dz", &ric_conv_bwd_dz,
        "Launch the RIC conv backward's cotangent sampling kernel; returns "
        "the cudaError_t code.");
  m.def("ric_conv_bwd_gemm", &ric_conv_bwd_gemm,
        "Launch the RIC conv backward's 3xTF32 split-K GEMM kernel; returns "
        "the cudaError_t code.");
  m.def("ric_conv_bwd_dwk_reduce", &ric_conv_bwd_dwk_reduce,
        "Launch the ordered sum of dwk's split-K slices; returns the "
        "cudaError_t code.");
  m.def("ric_conv_bwd_sum_slices", &ric_conv_bwd_sum_slices,
        "Launch the ordered sum of dx's split-K slices; returns the "
        "cudaError_t code.");
  m.def("hashgrid_fwd", &hashgrid_fwd,
        "Launch the hash-grid encode kernel (with its jacobian when denc is "
        "nonzero); returns the cudaError_t code.");
  m.def("hashgrid_bwd_terms", &hashgrid_bwd_terms,
        "Launch the kernel that writes the table gradient's keyed terms; "
        "returns the cudaError_t code.");
  m.def("hashgrid_bwd_segsum", &hashgrid_bwd_segsum,
        "Launch the ordered per-row sum of the sorted terms; returns the "
        "cudaError_t code.");
  m.def("row_gather", &row_gather,
        "Launch the fixed-width row gather kernel; returns the cudaError_t "
        "code.");
  m.def("error_string",
        [](int err) { return std::string(ric_conv_error_string(err)); },
        "cudaGetErrorString of a launch's return code.");
}
