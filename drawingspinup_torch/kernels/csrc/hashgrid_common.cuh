// Shared device code of the hash-grid kernels (hashgrid_fwd.cu,
// hashgrid_bwd.cu, row_gather.cu): the fixed-width row gather, the corner
// indices and trilinear factors of one (point, level), and the compute-dtype
// rounding. The math is drawingspinup_tpu/models/hashgrid.py::_level_interp
// (and its plain twin in drawingspinup_torch/kernels/hashgrid.py::_corners),
// operation for operation, so the kernels agree with the twins to the bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dsu_hashgrid {

constexpr int kMaxLevels = 16;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

// Per-level arguments, passed by value (kernel parameter space).
struct Levels {
  const void* table[kMaxLevels];   // (rows, F) table (forward only)
  long long base[kMaxLevels];      // first row in the flat gradient (backward)
  int res[kMaxLevels];             // resolution r; r + 1 vertices per axis
  int dense[kMaxLevels];           // 1: dense (r+1)^3 rows, 0: hashed
};

// out = tab[row], a row of WORDS 4-byte words, read through the read-only
// path in 16-, 8- or 4-byte pieces. The Pallas gathers (rowdma, vmemds of
// scripts/bench_pallas_gather.py) did this one row per DMA or per dynamic
// slice; here each thread fetches its own rows and the memory system keeps
// many in flight.
template <int WORDS>
__device__ __forceinline__ void gather_row(const uint32_t* __restrict__ tab,
                                           long long row, uint32_t* out) {
  const uint32_t* src = tab + row * WORDS;
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else if constexpr (WORDS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 2; ++i) {
      uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + i);
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) out[i] = __ldg(src + i);
  }
}

// tab[row] = in, the same pieces as gather_row.
template <int WORDS>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ dst_base,
                                          long long row,
                                          const uint32_t* in) {
  uint32_t* dst = dst_base + row * WORDS;
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
  } else if constexpr (WORDS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 2; ++i)
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(in[2 * i], in[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) dst[i] = in[i];
  }
}

// Value types: a table entry or a compute value, handled as f32 in
// registers; a bf16 compute value is kept rounded to bf16 after every
// operation, as PyTorch's (and the twins') bf16 elementwise ops round.
template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  template <int F>
  static __device__ __forceinline__ void unpack(const uint32_t* w, float* f) {
#pragma unroll
    for (int i = 0; i < F; ++i) f[i] = __uint_as_float(w[i]);
  }
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  template <int F>
  static __device__ __forceinline__ void unpack(const uint32_t* w, float* f) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      // little-endian: element 2k is the low half of word k
      uint32_t bits = (i & 1) ? (w[i / 2] & 0xffff0000u) : (w[i / 2] << 16);
      f[i] = __uint_as_float(bits);
    }
  }
};

// The 8 corners of one (point, level), x fastest (c = dx + 2 dy + 4 dz):
// row indices, and per axis the factors u[axis][d] (1 − w for d = 0, w for
// d = 1), all f32 as JAX computes them.
struct Corners {
  long long row[8];
  float u[3][2];
  float r;
};

__device__ __forceinline__ void corners(const float* __restrict__ xp, int res,
                                        bool dense, bool cell_rows,
                                        uint32_t table_mask, Corners& c) {
  const float r = static_cast<float>(res);
  c.r = r;
  int b0[3];
  const bool wide = dense && cell_rows;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f = __fmul_rn(xp[k], r);
    const float fl = floorf(f);
    int b = static_cast<int>(fl);
    float w;
    if (wide) {
      // clip the base corner to r − 1 and recompute the weight from it:
      // at px == 1 the far corner gets weight 1, a one-sided slope
      b = min(max(b, 0), res - 1);
      w = __fsub_rn(f, static_cast<float>(b));
    } else {
      w = __fsub_rn(f, fl);
    }
    b0[k] = b;
    c.u[k][0] = __fsub_rn(1.0f, w);
    c.u[k][1] = w;
  }
  const long long n = res + 1;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    int cx = b0[0] + (corner & 1);
    int cy = b0[1] + ((corner >> 1) & 1);
    int cz = b0[2] + ((corner >> 2) & 1);
    if (!wide) {
      cx = min(max(cx, 0), res);
      cy = min(max(cy, 0), res);
      cz = min(max(cz, 0), res);
    }
    if (dense) {
      c.row[corner] = cx + n * (cy + n * static_cast<long long>(cz));
    } else {
      const uint32_t h = static_cast<uint32_t>(cx) ^
                         (static_cast<uint32_t>(cy) * kPrime1) ^
                         (static_cast<uint32_t>(cz) * kPrime2);
      c.row[corner] = h & table_mask;
    }
  }
}

// Weight (ux·uy)·uz and, for the jacobian, the slopes (sx·uy)·uz,
// (ux·sy)·uz, (ux·uy)·sz of one corner, f32 then rounded to the compute
// dtype.
template <typename CT, bool JAC>
__device__ __forceinline__ void weights(const Corners& c, int corner,
                                        float& w, float& gx, float& gy,
                                        float& gz) {
  const int dx = corner & 1, dy = (corner >> 1) & 1, dz = (corner >> 2) & 1;
  const float ux = c.u[0][dx], uy = c.u[1][dy], uz = c.u[2][dz];
  const float uxy = __fmul_rn(ux, uy);
  w = Num<CT>::round(__fmul_rn(uxy, uz));
  if constexpr (JAC) {
    const float sx = dx ? c.r : -c.r;
    const float sy = dy ? c.r : -c.r;
    const float sz = dz ? c.r : -c.r;
    gx = Num<CT>::round(__fmul_rn(__fmul_rn(sx, uy), uz));
    gy = Num<CT>::round(__fmul_rn(__fmul_rn(ux, sy), uz));
    gz = Num<CT>::round(__fmul_rn(uxy, sz));
  }
}

}  // namespace dsu_hashgrid
