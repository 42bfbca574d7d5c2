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
// with the forward's corner rows and compute-dtype weights (hashgrid_fwd.cu);
// each term in f32, rounded after every product and sum as the plain twin
// rounds it. JAX instead rounds each contribution to bf16 and scatter-adds in
// bf16.
//
// Deterministic by fixed-point sums: integer addition is associative, so
// atomics that add int64 values give the same bits in any order, from run to
// run and under any permutation of the points. Three kernels:
//
//   1. scale: per level l the largest finite |g_enc|, |g_denc[k]| over the
//      level's columns (atomicMax on the bits of non-negative floats, which
//      order as unsigned ints);
//   2. scatter: one thread per (point, level), level-major so the branch on
//      dense/hashed is warp-uniform; each term t becomes the int64
//      rint(t * 2^e_l), computed in double (2^e_l leaves f32's range when the
//      gradients are tiny; the product is exact), added with a 64-bit red;
//      lanes of a warp whose corner hits one row add their values first
//      (__match_any_sync) and send one red: ray-ordered samples share the
//      coarse levels' rows within a warp;
//   3. convert: acc * 2^-e_l in double, rounded once to f32 and, for a bf16
//      table, from there to bf16 (as .to() rounds).
//
// The exponent: B_l = m_enc + r_l (m_x + m_y + m_z) bounds every term (the
// weights are at most 1, the slopes at most r_l; their roundings take at most
// 2^-7 of the headroom below), and a row sums at most 8P terms, so with
// e_l = 62 - ceil(log2(8 P B_l)) no row's sum leaves [-2^62 (1 + 2^-7) - 4P,
// 2^62 (1 + 2^-7) + 4P], inside int64. e_l = 0 where B_l = 0. Each term is
// rounded by at most 2^-(e_l+1), ~2^-42 B_l at a production step
// (P = 135 168), far below an f32 sequential sum's error except in rows
// whose sum is under ~2^-18 B_l; kernels/hashgrid.py::hashgrid_bwd_fixed_point
// is this arithmetic in plain PyTorch, bit for bit.
//
// Non-finite values propagate: a non-finite term adds nothing but sets its
// (row, feature) bit with atomicOr, and the convert writes NaN there.
//
// What bounds it on the card: the reds, 8 F per (point, level), 13 M at a
// production step before the aggregation; the accumulator (28 MB at 6
// levels) stays in the 50 MB L2. Memory traffic is ~110 MB (the cotangents'
// rows read twice, the accumulator zeroed and read once, the gradient
// written), ~0.03 ms at the HBM rate.

#include "hashgrid_common.cuh"

namespace {

using namespace dsu_hashgrid;

constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;
constexpr uint32_t kInfBits = 0x7f800000u;

// The scratch buffer, one zeroed int64 allocation: per level the four
// maxima's bits (uint32), then the non-finite bits of every (row, feature),
// then the accumulator.
struct Scratch {
  uint32_t* maxbits;
  unsigned long long* flags;
  long long* acc;
};

__host__ __device__ inline long long flag_words(long long elems) {
  return (elems + 63) / 64;
}

__host__ __device__ inline long long scratch_words(int n_active,
                                                   long long elems) {
  return 2LL * n_active + flag_words(elems) + elems;
}

__host__ __device__ inline Scratch carve(long long* base, int n_active,
                                         long long elems) {
  Scratch s;
  s.maxbits = reinterpret_cast<uint32_t*>(base);
  s.flags = reinterpret_cast<unsigned long long*>(base + 2LL * n_active);
  s.acc = base + 2LL * n_active + flag_words(elems);
  return s;
}

// e_l from level l's maxima, or 0 where they are all 0.
__device__ __forceinline__ int level_exponent(const uint32_t* maxbits, int l,
                                              int res, long long P) {
  const uint32_t* m = maxbits + 4 * l;
  const double b = __dadd_rn(
      static_cast<double>(__uint_as_float(m[0])),
      __dmul_rn(static_cast<double>(res),
                __dadd_rn(__dadd_rn(static_cast<double>(__uint_as_float(m[1])),
                                    static_cast<double>(__uint_as_float(m[2]))),
                          static_cast<double>(__uint_as_float(m[3])))));
  if (b == 0.0) return 0;
  int k;
  const double frac = frexp(__dmul_rn(b, static_cast<double>(8 * P)), &k);
  return 62 - (frac == 0.5 ? k - 1 : k);             // 62 - ceil(log2(8 P B))
}

// Pass 1. Thread t walks the items i = p * n_active + l (a point's active
// columns side by side, so a warp reads contiguous bytes) in steps of T, the
// grid's thread count, a multiple of n_active: its level l = t % n_active
// stays fixed. A block's threads of one level reduce in shared memory and
// send one atomicMax per maximum.
template <int F, typename CT, bool JAC>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_scale_kernel(long long P, int n_active, int stride,
                          const CT* __restrict__ g_enc,
                          const CT* __restrict__ g_denc,
                          uint32_t* __restrict__ maxbits) {
  __shared__ uint32_t part[kThreads][4];
  const long long items = P * n_active;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int l = static_cast<int>(t0 % n_active);
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  for (long long i = t0; i < items; i += step) {
    const long long o = (i / n_active) * stride + static_cast<long long>(l) * F;
#pragma unroll
    for (int k = 0; k < (JAC ? 4 : 1); ++k) {
      const CT* src = k == 0 ? g_enc : g_denc + (k - 1) * P * stride;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const uint32_t bits =
            __float_as_uint(fabsf(Num<CT>::load(src + o + f)));
        if (bits < kInfBits) m[k] = max(m[k], bits);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) part[threadIdx.x][k] = m[k];
  __syncthreads();
  // blockDim is a multiple of n_active, so thread j holds level j % n_active
  if (threadIdx.x < n_active) {
    uint32_t mm[4] = {0u, 0u, 0u, 0u};
    for (int j = threadIdx.x; j < blockDim.x; j += n_active) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mm[k] = max(mm[k], part[j][k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (mm[k]) atomicMax(maxbits + 4 * threadIdx.x + k, mm[k]);
  }
}

// Pass 2.
template <int F, typename CT, bool JAC>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_scatter_kernel(const float* __restrict__ x, long long P,
                            int n_active, Levels lv, int cell_rows,
                            uint32_t table_mask, int stride,
                            const CT* __restrict__ g_enc,
                            const CT* __restrict__ g_denc, Scratch s) {
  __shared__ long long stage[kThreads / kMaxLanes][kMaxLanes][F];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned active = __ballot_sync(0xffffffffu, tid < P * n_active);
  if (tid >= P * n_active) return;
  const int l = static_cast<int>(tid / P);
  const long long p = tid - l * P;
  const int lane = threadIdx.x % kMaxLanes;
  long long(*mine)[F] = stage[threadIdx.x / kMaxLanes];
  const double scale =
      ldexp(1.0, level_exponent(s.maxbits, l, lv.res[l], P));

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
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w, gx = 0.0f, gy = 0.0f, gz = 0.0f;
    weights<CT, JAC>(c, corner, w, gx, gy, gz);
    const long long row = lv.base[l] + c.row[corner];
    long long q[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float v = __fmul_rn(ge[f], w);
      if constexpr (JAC) {
        v = __fadd_rn(v, __fmul_rn(gdx[f], gx));
        v = __fadd_rn(v, __fmul_rn(gdy[f], gy));
        v = __fadd_rn(v, __fmul_rn(gdz[f], gz));
      }
      if (isfinite(v)) {
        q[f] = __double2ll_rn(__dmul_rn(static_cast<double>(v), scale));
      } else {
        const long long e = row * F + f;
        atomicOr(s.flags + e / 64, 1ull << (e % 64));
        q[f] = 0;
      }
    }
    // lanes on one row add their values first; the lowest sends the sum
    bool send = true;
    const unsigned peers = __match_any_sync(active, static_cast<unsigned>(row));
    if (__any_sync(active, peers != (1u << lane))) {
#pragma unroll
      for (int f = 0; f < F; ++f) mine[lane][f] = q[f];
      __syncwarp(active);
      send = __ffs(peers) - 1 == lane;
      if (send) {
        for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
          const int j = __ffs(rest) - 1;
#pragma unroll
          for (int f = 0; f < F; ++f) q[f] += mine[j][f];
        }
      }
      __syncwarp(active);
    }
    if (send) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (q[f] != 0)
          atomicAdd(reinterpret_cast<unsigned long long*>(s.acc + row * F + f),
                    static_cast<unsigned long long>(q[f]));
    }
  }
}

// Pass 3. One thread per row.
template <int F, typename OutT>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_convert_kernel(long long P, int n_active, Levels lv,
                            long long rows, Scratch s,
                            OutT* __restrict__ out) {
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  int l = 0;
  while (l + 1 < n_active && row >= lv.base[l + 1]) ++l;
  const double inv =
      ldexp(1.0, -level_exponent(s.maxbits, l, lv.res[l], P));
  const long long e0 = row * F;
  const unsigned long long bits = s.flags[e0 / 64] >> (e0 % 64);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float v =
        (bits >> f) & 1ull
            ? __int_as_float(0x7fc00000)
            : __double2float_rn(
                  __dmul_rn(__ll2double_rn(s.acc[e0 + f]), inv));
    Num<OutT>::store(out + e0 + f, v);
  }
}

template <int F, typename CT>
int launch(const float* x, long long P, int n_active, const Levels& lv,
           long long rows, int cell_rows, uint32_t mask, int stride,
           const void* g_enc_v, const void* g_denc_v, Scratch s, void* out,
           bool out_bf16, cudaStream_t st) {
  const CT* g_enc = static_cast<const CT*>(g_enc_v);
  const CT* g_denc = static_cast<const CT*>(g_denc_v);
  const long long items = P * n_active;
  // pass 1: a whole number of levels per block, at most 1056 blocks (8 for
  // each of the H100's 132 SMs)
  const int threads = kThreads - kThreads % n_active;
  const long long want = (items + threads - 1) / threads;
  const unsigned scale_blocks =
      static_cast<unsigned>(want < 1056 ? want : 1056);
  const unsigned blocks =
      static_cast<unsigned>((items + kThreads - 1) / kThreads);
  int err;
  if (g_denc) {
    hashgrid_bwd_scale_kernel<F, CT, true>
        <<<scale_blocks, threads, 0, st>>>(P, n_active, stride, g_enc, g_denc,
                                           s.maxbits);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    hashgrid_bwd_scatter_kernel<F, CT, true><<<blocks, kThreads, 0, st>>>(
        x, P, n_active, lv, cell_rows, mask, stride, g_enc, g_denc, s);
  } else {
    hashgrid_bwd_scale_kernel<F, CT, false>
        <<<scale_blocks, threads, 0, st>>>(P, n_active, stride, g_enc,
                                           nullptr, s.maxbits);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    hashgrid_bwd_scatter_kernel<F, CT, false><<<blocks, kThreads, 0, st>>>(
        x, P, n_active, lv, cell_rows, mask, stride, g_enc, nullptr, s);
  }
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const unsigned row_blocks =
      static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  if (out_bf16)
    hashgrid_bwd_convert_kernel<F, __nv_bfloat16>
        <<<row_blocks, kThreads, 0, st>>>(
            P, n_active, lv, rows, s, static_cast<__nv_bfloat16*>(out));
  else
    hashgrid_bwd_convert_kernel<F, float><<<row_blocks, kThreads, 0, st>>>(
        P, n_active, lv, rows, s, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int dispatch(bool cdt_bf16, const float* x, long long P, int n_active,
             const Levels& lv, long long rows, int cell_rows, uint32_t mask,
             int stride, const void* g_enc, const void* g_denc, Scratch s,
             void* out, bool out_bf16, cudaStream_t st) {
  if (cdt_bf16)
    return launch<F, __nv_bfloat16>(x, P, n_active, lv, rows, cell_rows, mask,
                                    stride, g_enc, g_denc, s, out, out_bf16,
                                    st);
  return launch<F, float>(x, P, n_active, lv, rows, cell_rows, mask, stride,
                          g_enc, g_denc, s, out, out_bf16, st);
}

}  // namespace

// int64 words of the zeroed scratch that hashgrid_bwd_launch takes, for
// n_active levels and elems = rows * F gradient values.
extern "C" long long hashgrid_bwd_scratch_words(int n_active,
                                                long long elems) {
  return scratch_words(n_active, elems);
}

// Plain C interface. The Python wrapper validates shapes, types, devices and
// contiguity, zeroes the scratch (hashgrid_bwd_scratch_words int64 words)
// and allocates out, the flat (rows, F) gradient of all active levels, f32
// or (out_bf16) bf16; row_base (n_active,) (host memory) holds the first row
// of each level in it. g_denc == nullptr: the forward had no jacobian.
// Returns the cudaError_t of the launches: 0 on success.
extern "C" int hashgrid_bwd_launch(const float* x, long long P, int n_active,
                                   const int* res, const int* dense,
                                   const long long* row_base, long long rows,
                                   int table_size, int F, int cell_rows,
                                   int cdt_bf16, int out_bf16, int stride,
                                   const void* g_enc, const void* g_denc,
                                   long long* scratch, void* out,
                                   void* stream) {
  if (n_active < 1 || n_active > kMaxLevels || P < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < n_active; ++l) {
    lv.base[l] = row_base[l];
    lv.res[l] = res[l];
    lv.dense[l] = dense[l];
  }
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  const Scratch s = carve(scratch, n_active, rows * F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 2:
      return dispatch<2>(cdt_bf16, x, P, n_active, lv, rows, cell_rows, mask,
                         stride, g_enc, g_denc, s, out, out_bf16, st);
    case 4:
      return dispatch<4>(cdt_bf16, x, P, n_active, lv, rows, cell_rows, mask,
                         stride, g_enc, g_denc, s, out, out_bf16, st);
    case 8:
      return dispatch<8>(cdt_bf16, x, P, n_active, lv, rows, cell_rows, mask,
                         stride, g_enc, g_denc, s, out, out_bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
