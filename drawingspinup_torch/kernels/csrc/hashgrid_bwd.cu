// Hash-grid encode backward: the gradient of the tables, for sm_90a.
//
// Replaces the VJP of drawingspinup_tpu/models/hashgrid.py::_level_interp
// (the transpose of JAX's table gathers, an XLA scatter-add on the TPU).
// Same math: for every (point p, level l, corner c, feature f)
//
//   grad_l[row_c(p)][f] += g_enc[p, l*F+f] * w_c
//                          + g_denc[0, p, l*F+f] * gx_c
//                          + g_denc[1, p, l*F+f] * gy_c
//                          + g_denc[2, p, l*F+f] * gz_c
//
// with the forward's corner rows and compute-dtype weights (hashgrid_fwd.cu),
// summed in f32. The wrapper casts the f32 sums once to the table dtype;
// JAX instead rounds each contribution to bf16 and scatter-adds in bf16, so
// in bf16 the two differ by that rounding (bounded in the tests).
//
// Deterministic, in two kernels around a stable sort (the wrapper's
// torch.sort): hashgrid_bwd_terms writes, per (level, point, corner), the
// row's key in one flat buffer of all levels' rows and its F f32 terms;
// the stable sort by key keeps equal keys in (level, point, corner) order;
// hashgrid_bwd_segsum then gives each run of equal keys to one thread,
// which sums the run's terms in that order and writes the row once. The
// sum's order is fixed by the inputs alone, so a step is bit-identical
// from run to run, as the JAX pipeline is (atomics would not be).
//
// What bounds it on the card: memory traffic of the entries (8 per point
// and level, a 4-byte key and 4F bytes of terms, written, sorted and read
// back), not arithmetic; the coarse levels' few thousand rows take long
// runs, which serialise in their thread (tens of terms each at a
// production step).

#include "hashgrid_common.cuh"

namespace {

using namespace dsu_hashgrid;

constexpr int kThreads = 256;

template <int F, typename CT, bool JAC>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_terms_kernel(const float* __restrict__ x, long long P,
                          int n_active, Levels lv, int cell_rows,
                          uint32_t table_mask, int stride,
                          const CT* __restrict__ g_enc,
                          const CT* __restrict__ g_denc,
                          int* __restrict__ keys, float* __restrict__ terms) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= P * n_active) return;
  const int l = static_cast<int>(tid / P);
  const long long p = tid - l * P;

  const long long o = p * stride + static_cast<long long>(l) * F;
  float ge[F], gdx[F], gdy[F], gdz[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    ge[f] = Num<CT>::load(g_enc + o + f);
    if constexpr (JAC) {
      const long long plane = P * stride;
      gdx[f] = Num<CT>::load(g_denc + o + f);
      gdy[f] = Num<CT>::load(g_denc + plane + o + f);
      gdz[f] = Num<CT>::load(g_denc + 2 * plane + o + f);
    }
  }

  Corners c;
  corners(x + 3 * p, lv.res[l], lv.dense[l] != 0, cell_rows != 0, table_mask,
          c);
  const long long e0 = tid * 8;       // entries in (level, point, corner)
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w, gx = 0.0f, gy = 0.0f, gz = 0.0f;
    weights<CT, JAC>(c, corner, w, gx, gy, gz);
    keys[e0 + corner] = static_cast<int>(lv.base[l] + c.row[corner]);
    float* t = terms + (e0 + corner) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float v = __fmul_rn(ge[f], w);
      if constexpr (JAC) {
        v = __fadd_rn(v, __fmul_rn(gdx[f], gx));
        v = __fadd_rn(v, __fmul_rn(gdy[f], gy));
        v = __fadd_rn(v, __fmul_rn(gdz[f], gz));
      }
      t[f] = v;
    }
  }
}

// One thread per sorted entry; the first entry of each run of equal keys
// sums the run, in order, into its row.
template <int F>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_segsum_kernel(const int* __restrict__ sorted_keys,
                           const long long* __restrict__ order,
                           const float* __restrict__ terms, long long n,
                           float* __restrict__ grad) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = sorted_keys[i];
  if (i > 0 && sorted_keys[i - 1] == key) return;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (long long j = i; j < n && sorted_keys[j] == key; ++j) {
    const float* t = terms + order[j] * F;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], t[f]);
  }
  float* dst = grad + static_cast<long long>(key) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) dst[f] = acc[f];
}

template <int F, typename CT>
int launch_terms(const float* x, long long P, int n_active, const Levels& lv,
                 int cell_rows, uint32_t mask, int stride, const void* g_enc,
                 const void* g_denc, int* keys, float* terms, cudaStream_t s) {
  const long long n = P * n_active;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (g_denc) {
    hashgrid_bwd_terms_kernel<F, CT, true><<<blocks, kThreads, 0, s>>>(
        x, P, n_active, lv, cell_rows, mask, stride,
        static_cast<const CT*>(g_enc), static_cast<const CT*>(g_denc), keys,
        terms);
  } else {
    hashgrid_bwd_terms_kernel<F, CT, false><<<blocks, kThreads, 0, s>>>(
        x, P, n_active, lv, cell_rows, mask, stride,
        static_cast<const CT*>(g_enc), nullptr, keys, terms);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int dispatch_terms(bool cdt_bf16, const float* x, long long P, int n_active,
                   const Levels& lv, int cell_rows, uint32_t mask, int stride,
                   const void* g_enc, const void* g_denc, int* keys,
                   float* terms, cudaStream_t s) {
  if (cdt_bf16)
    return launch_terms<F, __nv_bfloat16>(x, P, n_active, lv, cell_rows, mask,
                                          stride, g_enc, g_denc, keys, terms,
                                          s);
  return launch_terms<F, float>(x, P, n_active, lv, cell_rows, mask, stride,
                                g_enc, g_denc, keys, terms, s);
}

template <int F>
int launch_segsum(const int* sorted_keys, const long long* order,
                  const float* terms, long long n, float* grad,
                  cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  hashgrid_bwd_segsum_kernel<F><<<blocks, kThreads, 0, s>>>(
      sorted_keys, order, terms, n, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface. The Python wrapper validates shapes, types, devices and
// contiguity and allocates the scratch: keys (P·n_active·8,) int32 and terms
// (P·n_active·8, F) f32; row_base (n_active,) (host memory) holds the first
// row of each level in the flat gradient; g_denc == nullptr: the forward had
// no jacobian. Each returns the cudaError_t of its launch: 0 on success.
extern "C" int hashgrid_bwd_terms_launch(const float* x, long long P,
                                         int n_active, const int* res,
                                         const int* dense,
                                         const long long* row_base,
                                         int table_size, int F, int cell_rows,
                                         int cdt_bf16, int stride,
                                         const void* g_enc, const void* g_denc,
                                         int* keys, float* terms,
                                         void* stream) {
  if (n_active < 1 || n_active > kMaxLevels || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < n_active; ++l) {
    lv.base[l] = row_base[l];
    lv.res[l] = res[l];
    lv.dense[l] = dense[l];
  }
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 2:
      return dispatch_terms<2>(cdt_bf16, x, P, n_active, lv, cell_rows, mask,
                               stride, g_enc, g_denc, keys, terms, s);
    case 4:
      return dispatch_terms<4>(cdt_bf16, x, P, n_active, lv, cell_rows, mask,
                               stride, g_enc, g_denc, keys, terms, s);
    case 8:
      return dispatch_terms<8>(cdt_bf16, x, P, n_active, lv, cell_rows, mask,
                               stride, g_enc, g_denc, keys, terms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// sorted_keys (n,) int32 and order (n,) int64 from a stable sort of the
// terms kernel's keys; grad the zeroed flat f32 gradient of all levels.
extern "C" int hashgrid_bwd_segsum_launch(const int* sorted_keys,
                                          const long long* order,
                                          const float* terms, long long n,
                                          int F, float* grad, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 2: return launch_segsum<2>(sorted_keys, order, terms, n, grad, s);
    case 4: return launch_segsum<4>(sorted_keys, order, terms, n, grad, s);
    case 8: return launch_segsum<8>(sorted_keys, order, terms, n, grad, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
