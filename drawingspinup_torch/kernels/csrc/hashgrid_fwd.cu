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
// so the gathers mostly hit L2. The 8 row loads of an item are sent back to
// back for memory-level parallelism.
//
// The stores: a block owns a tile of consecutive points and all L levels.
// Its warps take (point, level) items level-major, so the index math and
// the branch on dense/hashed stay warp-uniform, and put the results in a
// shared-memory image of the tile's rows (zeros for the levels past
// n_active); the block then writes each plane's image, one contiguous span
// of enc or denc, with 16-byte stores: a warp of items storing their own F
// values straight to enc would touch ~40 sectors per store instruction,
// each 1/8 used. Staging coarse tables in shared memory and sorting points
// by cell are later work.

#include "hashgrid_common.cuh"

namespace {

using namespace dsu_hashgrid;

constexpr int kThreads = 256;
constexpr int kTileBytes = 24 * 1024;   // a tile's image: several blocks a SM

// dst[0, n) = src[0, n) for n a multiple of 4 bytes, by the whole block:
// 16-byte stores where dst allows them.
__device__ __forceinline__ void copy_out(const unsigned char* src,
                                         unsigned char* dst, int nbytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n16 = nbytes / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    done = n16 * 4;
  }
  for (int i = done + threadIdx.x; i < nbytes / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(dst)[i] =
        reinterpret_cast<const uint32_t*>(src)[i];
}

template <int F, typename TabT, typename CT, bool JAC>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ x, long long P, int n_active,
                    Levels lv, int cell_rows, uint32_t table_mask, int stride,
                    int tile, CT* __restrict__ enc, CT* __restrict__ denc) {
  constexpr int WORDS = F * static_cast<int>(sizeof(TabT)) / 4;
  constexpr int PLANES = JAC ? 4 : 1;
  extern __shared__ __align__(16) unsigned char image[];
  CT* img = reinterpret_cast<CT*>(image);   // [PLANES][tile][stride]
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const int np = static_cast<int>(P - p0 < tile ? P - p0 : tile);
  const int plane = tile * stride;
  const int items = tile * (stride / F);

  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int l = i / tile;
    const int pt = i - l * tile;
    if (pt >= np) continue;
    CT* o = img + pt * stride + l * F;
    if (l >= n_active) {
#pragma unroll
      for (int k = 0; k < PLANES; ++k)
#pragma unroll
        for (int f = 0; f < F; ++f) Num<CT>::store(o + k * plane + f, 0.0f);
      continue;
    }
    Corners c;
    corners(x + 3 * (p0 + pt), lv.res[l], lv.dense[l] != 0, cell_rows != 0,
            table_mask, c);
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
#pragma unroll
    for (int f = 0; f < F; ++f) {
      Num<CT>::store(o + f, acc[f]);
      if constexpr (JAC) {
        Num<CT>::store(o + plane + f, jx[f]);
        Num<CT>::store(o + 2 * plane + f, jy[f]);
        Num<CT>::store(o + 3 * plane + f, jz[f]);
      }
    }
  }
  __syncthreads();
  const int nbytes = np * stride * static_cast<int>(sizeof(CT));
  const long long row0 = p0 * stride;
  copy_out(image, reinterpret_cast<unsigned char*>(enc + row0), nbytes);
  if constexpr (JAC) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      copy_out(image + (k + 1) * plane * sizeof(CT),
               reinterpret_cast<unsigned char*>(denc + k * P * stride + row0),
               nbytes);
  }
}

template <int F, typename TabT, typename CT, bool JAC>
int launch_one(const float* x, long long P, int n_active, const Levels& lv,
               int cell_rows, uint32_t mask, int stride, CT* enc, CT* denc,
               cudaStream_t s) {
  constexpr int PLANES = JAC ? 4 : 1;
  const int per_point = PLANES * stride * static_cast<int>(sizeof(CT));
  int tile = kTileBytes / per_point / 32 * 32;
  tile = tile < 32 ? 32 : (tile > 128 ? 128 : tile);
  const int smem = tile * per_point;
  auto kernel = hashgrid_fwd_kernel<F, TabT, CT, JAC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((P + tile - 1) / tile);
  kernel<<<blocks, kThreads, smem, s>>>(x, P, n_active, lv, cell_rows, mask,
                                         stride, tile, enc, denc);
  return static_cast<int>(cudaGetLastError());
}

template <int F, typename TabT, typename CT>
int launch(const float* x, long long P, int n_active, const Levels& lv,
           int cell_rows, uint32_t mask, int stride, void* enc, void* denc,
           cudaStream_t s) {
  if (denc)
    return launch_one<F, TabT, CT, true>(x, P, n_active, lv, cell_rows, mask,
                                         stride, static_cast<CT*>(enc),
                                         static_cast<CT*>(denc), s);
  return launch_one<F, TabT, CT, false>(x, P, n_active, lv, cell_rows, mask,
                                        stride, static_cast<CT*>(enc),
                                        nullptr, s);
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
// and contiguity, and allocates enc (P, stride) and denc (3, P, stride),
// stride = L F for all L levels; the kernel writes every column, zeros past
// n_active; denc == nullptr skips the jacobian). Returns the cudaError_t of
// the launch: 0 on success.
extern "C" int hashgrid_fwd_launch(const float* x, long long P, int n_active,
                                   const void* const* tables, const int* res,
                                   const int* dense, int table_size, int F,
                                   int cell_rows, int tab_bf16, int cdt_bf16,
                                   int stride, void* enc, void* denc,
                                   void* stream) {
  if (n_active < 1 || n_active > kMaxLevels || P < 1 || F < 1 ||
      stride % F != 0 || stride / F < n_active)
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
