// Multi-resolution hash-grid encode (and its spatial jacobian), for sm_90a.
//
// Replaces the hash-grid encode of drawingspinup_tpu/models/hashgrid.py
// (_level_interp under encode / encode_with_spatial_grad: XLA gathers on the
// TPU) and, for its corner fetch, the Pallas row gathers rowdma_kernel and
// vmemds_kernel of scripts/bench_pallas_gather.py (see row_gather.cu and
// gather_row in hashgrid_common.cuh). Same math:
//
//   enc[p, l*F+f]    = sum_c table_l[row_c(p)][f] * w_c(p)
//   denc[k, p, l*F+f] = sum_c table_l[row_c(p)][f] * dw_c(p)/dx_k
//
// over the 8 cell corners c, with row_c the dense index (x + n(y + n z)) or
// the spatial hash (x ^ y*2654435761 ^ z*805459861) & (T-1), f32 trilinear
// weights and feature x weight sums in the compute dtype (f32 or bf16, each
// product and sum rounded as the plain twin rounds them).
//
// What bounds it on the card: memory latency of the gathers, not
// arithmetic. One (point, level) costs 8 row reads of 4-8 bytes at
// scattered addresses (~100 flop of index and weight math around them) and
// writes F (4F with the jacobian) values. The coarse levels' tables (0.2-2.8
// MB in bf16) stay in L2; the hashed levels' 2 MB tables do too (50 MB L2),
// so the gathers mostly hit L2. Design for now: one thread per (point,
// level), threads of a warp on consecutive points of one level so the index
// math and the branch on dense/hashed are uniform, the 8 row loads sent
// back to back for memory-level parallelism. Staging coarse tables in
// shared memory and sorting points by cell are later work.

#include "hashgrid_common.cuh"

namespace {

using namespace dsu_hashgrid;

constexpr int kThreads = 256;

template <int F, typename TabT, typename CT, bool JAC>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ x, long long P, int n_active,
                    Levels lv, int cell_rows, uint32_t table_mask, int stride,
                    CT* __restrict__ enc, CT* __restrict__ denc) {
  constexpr int WORDS = F * static_cast<int>(sizeof(TabT)) / 4;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= P * n_active) return;
  const int l = static_cast<int>(tid / P);
  const long long p = tid - l * P;

  Corners c;
  corners(x + 3 * p, lv.res[l], lv.dense[l] != 0, cell_rows != 0, table_mask,
          c);
  const uint32_t* tab = static_cast<const uint32_t*>(lv.table[l]);

  uint32_t words[8][WORDS];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner)
    gather_row<WORDS>(tab, c.row[corner], words[corner]);

  float acc[F], jx[F], jy[F], jz[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = jx[f] = jy[f] = jz[f] = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float g[F];
    Num<TabT>::template unpack<F>(words[corner], g);
    float w, gx = 0.0f, gy = 0.0f, gz = 0.0f;
    weights<CT, JAC>(c, corner, w, gx, gy, gz);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float v = Num<CT>::round(g[f]);      // table → compute dtype
      acc[f] = Num<CT>::round(
          __fadd_rn(acc[f], Num<CT>::round(__fmul_rn(v, w))));
      if constexpr (JAC) {
        jx[f] = Num<CT>::round(
            __fadd_rn(jx[f], Num<CT>::round(__fmul_rn(v, gx))));
        jy[f] = Num<CT>::round(
            __fadd_rn(jy[f], Num<CT>::round(__fmul_rn(v, gy))));
        jz[f] = Num<CT>::round(
            __fadd_rn(jz[f], Num<CT>::round(__fmul_rn(v, gz))));
      }
    }
  }
  const long long o = p * stride + static_cast<long long>(l) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) Num<CT>::store(enc + o + f, acc[f]);
  if constexpr (JAC) {
    const long long plane = P * stride;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      Num<CT>::store(denc + o + f, jx[f]);
      Num<CT>::store(denc + plane + o + f, jy[f]);
      Num<CT>::store(denc + 2 * plane + o + f, jz[f]);
    }
  }
}

template <int F, typename TabT, typename CT>
int launch(const float* x, long long P, int n_active, const Levels& lv,
           int cell_rows, uint32_t mask, int stride, void* enc, void* denc,
           cudaStream_t s) {
  const long long n = P * n_active;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (denc) {
    hashgrid_fwd_kernel<F, TabT, CT, true><<<blocks, kThreads, 0, s>>>(
        x, P, n_active, lv, cell_rows, mask, stride, static_cast<CT*>(enc),
        static_cast<CT*>(denc));
  } else {
    hashgrid_fwd_kernel<F, TabT, CT, false><<<blocks, kThreads, 0, s>>>(
        x, P, n_active, lv, cell_rows, mask, stride, static_cast<CT*>(enc),
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int dispatch_types(bool tab_bf16, bool cdt_bf16, const float* x, long long P,
                   int n_active, const Levels& lv, int cell_rows,
                   uint32_t mask, int stride, void* enc, void* denc,
                   cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (tab_bf16 && cdt_bf16)
    return launch<F, bf16, bf16>(x, P, n_active, lv, cell_rows, mask, stride,
                                 enc, denc, s);
  if (tab_bf16)
    return launch<F, bf16, float>(x, P, n_active, lv, cell_rows, mask, stride,
                                  enc, denc, s);
  if (cdt_bf16)
    return launch<F, float, bf16>(x, P, n_active, lv, cell_rows, mask, stride,
                                  enc, denc, s);
  return launch<F, float, float>(x, P, n_active, lv, cell_rows, mask, stride,
                                 enc, denc, s);
}

}  // namespace

// Plain C interface (the Python wrapper validates shapes, types, devices
// and contiguity, and allocates enc (P, stride) and denc (3, P, stride);
// denc == nullptr skips the jacobian). Returns the cudaError_t of the
// launch: 0 on success.
extern "C" int hashgrid_fwd_launch(const float* x, long long P, int n_active,
                                   const void* const* tables, const int* res,
                                   const int* dense, int table_size, int F,
                                   int cell_rows, int tab_bf16, int cdt_bf16,
                                   int stride, void* enc, void* denc,
                                   void* stream) {
  if (n_active < 1 || n_active > kMaxLevels || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < n_active; ++l) {
    lv.table[l] = tables[l];
    lv.res[l] = res[l];
    lv.dense[l] = dense[l];
  }
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 2:
      return dispatch_types<2>(tab_bf16, cdt_bf16, x, P, n_active, lv,
                               cell_rows, mask, stride, enc, denc, s);
    case 4:
      return dispatch_types<4>(tab_bf16, cdt_bf16, x, P, n_active, lv,
                               cell_rows, mask, stride, enc, denc, s);
    case 8:
      return dispatch_types<8>(tab_bf16, cdt_bf16, x, P, n_active, lv,
                               cell_rows, mask, stride, enc, denc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
