// Rotation-invariant 3x3 conv (RIC conv), backward (VJP), f32, for sm_90a:
// the sampled cotangent and the ordered sums of the split-K products.
//
// Replaces the Pallas TPU kernel drawingspinup_tpu/kernels/ric_conv.py::
// _bwd_kernel (driven by _bwd_call, the custom VJP of ric_conv), together
// with ric_conv_bwd_gemm.cu. Same math, with off_i the offset of shift
// i = (sy,sx) = (i/3-1, i%3-1) and [.] for "inside the image":
//
//   dz_t[n,q,:] = sum_i swf[i,t,q] * [q-off_i] * g[n,q-off_i,:]
//   dx[n,q,:]   = sum_t dz_t[n,q,:] @ wk[t]^T             (contract O)
//   dwk[t]      = sum_{n,q} x[n,q,:]^T (x) dz_t[n,q,:]     (contract pixels)
//
// with x (N,H,W,C), wk (9,C,O), swf (9 shifts, 9 taps, H, W), g (N,H,W,O),
// all f32 and contiguous; dx (N,H,W,C), dwk (9,C,O). No gradient to swf.
//
// The TPU kernel kept nine whole-block (rows, O) cotangent copies and the
// (9,C,O) gradient resident in VMEM across a sequential grid. Here blocks
// run in parallel, so the backward is four launches (kernels/ric_conv.py::
// ric_conv_bwd):
//
//   1. ric_conv_dz_kernel (this file) samples dz_t for every tap once into
//      an (N*H*W, 9, O) scratch: 73*O FMAs per pixel, ~4*9*O bytes written.
//      A block owns an 8x16 pixel tile and 32 cotangent channels, with a
//      one-pixel halo of g and the tile's 81 weight planes in shared
//      memory. Out-of-image sources are never read: their halo cells and
//      weights are zeros, so a non-finite g there gives hard zeros, as the
//      TPU kernel's where() does. The 8 (tap 4, shift != 4) planes, zero by
//      construction, are skipped (the TPU kernel's _active).
//   2. dx = dz . wk^T and 3. dwk = x^T . dz, GEMMs on the tensor cores
//      (ric_conv_bwd_gemm.cu), each into fixed split-K partial buffers
//      where the shape needs the blocks.
//   4. The ordered sums below: slices added in index order, dwk permuted
//      from (C, 9*O) to (9, C, O). No float atomics anywhere, so two runs
//      give the same bits.
//
// The bound and the products' design are in ric_conv_bwd_gemm.cu; these
// kernels move bytes (dz's trip through device memory, ~2 x 4*9*O bytes a
// pixel, and the partial buffers) and are a small share of the time.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TH = 8;                       // pixel tile rows
constexpr int TW = 16;                      // pixel tile cols
constexpr int NP = TH * TW;                 // pixels per tile
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;     // halo tile cells
constexpr int NT = 256;                     // threads per block
constexpr int NPLANE = 81;                  // (tap, shift) weight planes

__device__ __forceinline__ bool active(int t, int i) { return t != 4 || i == 4; }

// swf[i,t,q] where q and its source q - off_i lie inside the image and the
// plane is active, else 0.
__device__ __forceinline__ float plane_weight(const float* __restrict__ swf,
                                              int t, int i, int qy, int qx,
                                              int H, int W) {
  const int sy = qy - (i / 3 - 1);
  const int sx = qx - (i % 3 - 1);
  if (!active(t, i) || qy >= H || qx >= W || sy < 0 || sy >= H || sx < 0 ||
      sx >= W)
    return 0.f;
  const size_t hw = static_cast<size_t>(H) * W;
  return swf[static_cast<size_t>(i * 9 + t) * hw + static_cast<size_t>(qy) * W + qx];
}

// dz[n,q,t,o] for every tap, written once: a block owns an 8x16 pixel tile
// and 32 cotangent channels (one per lane), with a one-pixel halo of g and
// the tile's 81 weight planes in shared memory.
constexpr int OZ = 32;                      // cotangent channels per dz block
constexpr size_t DZ_SMEM_BYTES = (NPLANE * NP + HALO * OZ) * sizeof(float);

__global__ void __launch_bounds__(NT)
ric_conv_dz_kernel(const float* __restrict__ g, const float* __restrict__ swf,
                   float* __restrict__ dz, int H, int W, int O,
                   int o_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                        // [t*9+i][NP]
  float* gsz = wsm + NPLANE * NP;           // [cell][OZ]: g halo tile

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / o_chunks;
  const int o0 = (blockIdx.z % o_chunks) * OZ;
  const size_t hw = static_cast<size_t>(H) * W;
  const float* gn = g + static_cast<size_t>(n) * hw * O;

  for (int e = tid; e < NPLANE * NP; e += NT) {
    const int p = e % NP;
    const int plane = e / NP;
    wsm[e] = plane_weight(swf, plane / 9, plane % 9, ty0 + p / TW,
                          tx0 + p % TW, H, W);
  }
  for (int e = tid; e < HALO * OZ; e += NT) {
    const int o = e % OZ;
    const int cell = e / OZ;
    const int gy = ty0 - 1 + cell / HALO_W;
    const int gx = tx0 - 1 + cell % HALO_W;
    float v = 0.f;
    if (o0 + o < O && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = gn[(static_cast<size_t>(gy) * W + gx) * O + o0 + o];
    gsz[e] = v;
  }
  __syncthreads();

  const int lane = tid % 32;
  if (o0 + lane >= O) return;
  for (int p = tid / 32; p < NP; p += NT / 32) {
    const int py = ty0 + p / TW;
    const int px = tx0 + p % TW;
    if (py >= H || px >= W) continue;
    const float* gp = gsz + ((p / TW + 1) * HALO_W + p % TW + 1) * OZ + lane;
    float gv[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      gv[i] = gp[(-(i / 3 - 1) * HALO_W - (i % 3 - 1)) * OZ];
    float* out = dz + ((static_cast<size_t>(n) * H + py) * W + px) * 9 * O +
                 o0 + lane;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float* wt = wsm + t * 9 * NP + p;
      float v;
      if (t == 4) {
        v = wt[4 * NP] * gv[4];             // center tap: only the center shift
      } else {
        v = 0.f;
#pragma unroll
        for (int i = 0; i < 9; ++i) v = fmaf(wt[i * NP], gv[i], v);
      }
      out[t * O] = v;
    }
  }
}

// dwk[t, c, o] = sum_s part[s, c, t*O + o], s in index order.
__global__ void ric_conv_dwk_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ dwk, int C,
                                           int O, int slices) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int elems = 9 * C * O;
  if (e >= elems) return;
  const int t = e / (C * O);
  const int c = (e / O) % C;
  const int o = e % O;
  const size_t src = static_cast<size_t>(c) * 9 * O + t * O + o;
  float v = 0.f;
  for (int s = 0; s < slices; ++s) v += part[static_cast<size_t>(s) * elems + src];
  dwk[e] = v;
}

// out[e] = sum_s part[s, e], s in index order (dx's slices).
__global__ void ric_conv_sum_slices_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           long long elems, int slices) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= elems) return;
  float v = 0.f;
  for (int s = 0; s < slices; ++s) v += part[s * elems + e];
  out[e] = v;
}

}  // namespace

// Plain C interface (the Python wrapper validates shapes, types, devices and
// contiguity, and allocates the outputs and the scratch). Each returns the
// cudaError_t of its launch: 0 on success.

// dz: (N*H*W, 9, O) floats, the sampled cotangent of every tap.
extern "C" int ric_conv_bwd_dz_launch(const float* g, const float* swf,
                                      float* dz, int n, int h, int w, int o,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ric_conv_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DZ_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int o_chunks = (o + OZ - 1) / OZ;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n * o_chunks);
  ric_conv_dz_kernel<<<grid, NT, DZ_SMEM_BYTES, st>>>(g, swf, dz, h, w, o,
                                                      o_chunks);
  return static_cast<int>(cudaGetLastError());
}

// part: (slices, C, 9*O) partial products of x^T dz; dwk: (9, C, O).
extern "C" int ric_conv_bwd_dwk_reduce_launch(const float* part, float* dwk,
                                              int c, int o, int slices,
                                              void* stream) {
  if (slices < 1) return static_cast<int>(cudaErrorInvalidValue);
  ric_conv_dwk_reduce_kernel<<<(9 * c * o + 255) / 256, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      part, dwk, c, o, slices);
  return static_cast<int>(cudaGetLastError());
}

// part: (slices, elems) partial products; out: (elems,) their sum.
extern "C" int ric_conv_bwd_sum_slices_launch(const float* part, float* out,
                                              long long elems, int slices,
                                              void* stream) {
  if (slices < 1 || elems < 1) return static_cast<int>(cudaErrorInvalidValue);
  ric_conv_sum_slices_kernel<<<static_cast<unsigned>((elems + 255) / 256),
                               256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, out, elems, slices);
  return static_cast<int>(cudaGetLastError());
}
