// One NSR step's pixel rays and targets in one launch, for sm_90a.
//
// Replaces, on the recon path, the row-gather kernel (row_gather.cu, the
// port of scripts/bench_pallas_gather.py's pallas_gather(kind="rowdma"))
// together with the ~25 elementwise, index and einsum launches around it in
// train/nsr.py::sample_pixel_rays. One thread a ray r:
//
//   row  = clamp((vi·H + yi)·W + xi, 0, V·H·W − 1)    target row (48 B)
//   v    = clamp(vi, 0, V − 1)
//   ox   = ((xi + 0.5) · (1/W) − 0.5) · 2,  oy likewise with H
//   rays_d = R[v][:, 2] / max(|R[v][:, 2]|, 1e-9)
//   rays_o = R[v] · (ox, oy, 0) + t[v]
//   px   = pixels[row],  vw = view_weights[v]
//
// with c2w[v] = [R | t] (3×4). The draws (vi, yi, xi) are the step's int64
// draws, so the random stream stays the plain path's. Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn, which nvcc never contracts
// into an fma), in the plain function's order; the divisions by W and H are
// a product with the f32 reciprocal, as PyTorch's CUDA division by a Python
// scalar computes them. The plain function's norm and einsum run in cuBLAS
// and a reduction kernel, whose order of operations is theirs, so the rays
// agree with it to a few ulp and the rows and view weights to the bit.
//
// What bounds it on the card: one launch's latency. The bytes are ~0.2 MB
// a step (2048 rays); there is no host-to-device copy and no host sync.

#include "hashgrid_common.cuh"

namespace {

using namespace dsu_hashgrid;

constexpr int kThreads = 128;
constexpr int kRowWords = 12;    // PIXEL_COLUMNS f32

__device__ __forceinline__ long long clamp_ll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
pixel_rays_kernel(const long long* __restrict__ vi,
                  const long long* __restrict__ yi,
                  const long long* __restrict__ xi, long long R,
                  const float* __restrict__ c2w,
                  const float* __restrict__ view_weights, int V, int H, int W,
                  const uint32_t* __restrict__ pixels,
                  float* __restrict__ rays_o, float* __restrict__ rays_d,
                  uint32_t* __restrict__ px, float* __restrict__ vw) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long v_raw = __ldg(vi + r), y = __ldg(yi + r), x = __ldg(xi + r);
  const long long rows = static_cast<long long>(V) * H * W;
  const long long row = clamp_ll((v_raw * H + y) * W + x, rows - 1);
  const long long v = clamp_ll(v_raw, V - 1);

  // the target row first: its loads are the longest in flight
  uint32_t w[kRowWords];
  gather_row<kRowWords>(pixels, row, w);

  const float* m = c2w + v * 12;   // row-major [R | t], 3 × 4
  float rot[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rot[i][j] = __ldg(m + 4 * i + j);
    t[i] = __ldg(m + 4 * i + 3);
  }
  const float inv_w = __fdiv_rn(1.0f, static_cast<float>(W));
  const float inv_h = __fdiv_rn(1.0f, static_cast<float>(H));
  const float ox = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), inv_w),
                -0.5f),
      2.0f);
  const float oy = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), inv_h),
                -0.5f),
      2.0f);

  float d[3], o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // R · (0, 0, 1) and R · (ox, oy, 0), summed over j in order
    d[i] = __fadd_rn(__fadd_rn(__fmul_rn(rot[i][0], 0.0f),
                               __fmul_rn(rot[i][1], 0.0f)),
                     __fmul_rn(rot[i][2], 1.0f));
    o[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(rot[i][0], ox),
                                         __fmul_rn(rot[i][1], oy)),
                               __fmul_rn(rot[i][2], 0.0f)),
                     t[i]);
  }
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]),
                                       __fmul_rn(d[1], d[1])),
                             __fmul_rn(d[2], d[2]));
  const float n = fmaxf(__fsqrt_rn(n2), 1e-9f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rays_d[3 * r + i] = __fdiv_rn(d[i], n);
    rays_o[3 * r + i] = o[i];
  }
  store_row<kRowWords>(px, r, w);
  vw[r] = __ldg(view_weights + v);
}

}  // namespace

// Plain C interface: vi, yi, xi (R,) int64; c2w (V, 3, 4), view_weights
// (V,) and pixels (V·H·W, 12) f32, contiguous; rays_o, rays_d (R, 3), px
// (R, 12) and vw (R,) f32 allocated by the wrapper. Returns the cudaError_t
// of the launch: 0 on success.
extern "C" int pixel_rays_launch(const long long* vi, const long long* yi,
                                 const long long* xi, long long R,
                                 const float* c2w, const float* view_weights,
                                 int V, int H, int W, const float* pixels,
                                 float* rays_o, float* rays_d, float* px,
                                 float* vw, void* stream) {
  if (R < 1 || V < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((R + kThreads - 1) / kThreads);
  pixel_rays_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vi, yi, xi, R, c2w, view_weights, V, H, W,
      reinterpret_cast<const uint32_t*>(pixels), rays_o, rays_d,
      reinterpret_cast<uint32_t*>(px), vw);
  return static_cast<int>(cudaGetLastError());
}
