// Rotation-invariant 3x3 conv (RIC conv), forward, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel drawingspinup_tpu/kernels/ric_conv.py::
// _fwd_kernel (driven by _fwd_call, exposed as ric_conv). Same math:
//
//   out[n,p,:] = sum_i valid_i(p) * sum_t swf[i,t,p+off_i] * (x[n,p+off_i,:] @ wk[t])
//
// with x (N,H,W,C), wk (9,C,O), swf (9 shifts, 9 taps, H, W), all f32 and
// contiguous, out (N,H,W,O) f32. Shift i is (sy,sx) = (i/3-1, i%3-1).
//
// What bounds it on the card: arithmetic, not device memory. One output
// pixel costs 9*C*O FMAs of channel matmul plus 73*C FMAs of tap sampling,
// against about (C + 81 + O) floats of memory traffic; at the largest layer
// of a 512^2 frame (C=192, O=128) that is ~270 flop per byte, far above the
// f32 CUDA-core ridge (~20 flop/byte on an H100). Within the SM, the inner
// loop's shared-memory loads bound it: three 16-byte loads feed 32 FMAs
// (OT=64), and it runs at ~19 TFLOP/s at every serving shape on an H100 SXM
// at 700 W, ~28% of the f32 peak; a larger register tile is the next step.
// Shared memory is also why the TPU design does not carry over: it kept the
// nine (rows, O) tap products z_t = x @ wk[t] of whole images resident in
// VMEM and then mixed them per pixel, which a 227 KB block cannot hold (nor
// could VMEM at 512^2).
//
// Design:
//   * Use swf[i,t,p+off_i] = sw[t,i,p] (generator_j.py::ric_shifted_weights)
//     to sample first: u_t[p,:] = sum_i valid_i(p) * swf[i,t,p+off_i] *
//     x[p+off_i,:] is a bilinear sample of x, built from a shared-memory tile
//     of x with a one-pixel halo. Then acc[p,o] += u_t[p,:] @ wk[t][:,o].
//     The matmul runs on C channels once per tap, not once per shift.
//   * A block owns an 8x16 pixel tile and OT (32 or 64) output channels.
//     C is walked in chunks of CK=16. Each thread keeps a PPT x 4 register
//     tile of sums; every output element is owned by exactly one thread, so
//     there are no atomics and runs are bit-identical.
//   * Sources outside the image are never read from global memory: their
//     halo cells and their tap weights are stored as zeros.
//   * The 8 (shift, tap) planes where the center tap meets a non-center
//     shift are identically zero and are skipped (the TPU kernel's _active).
//   * Plain f32 FMA, f32 accumulation. No TF32 tensor cores: they would
//     break parity with the f32 reference. Speed is for later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TH = 8;                       // output tile rows
constexpr int TW = 16;                      // output tile cols
constexpr int NP = TH * TW;                 // output pixels per block
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;     // halo tile cells
constexpr int XS_STRIDE = HALO + 1;         // odd stride: channel rows spread over banks
constexpr int CK = 16;                      // input channels per chunk
constexpr int NT = 256;                     // threads per block
constexpr int NPLANE = 81;                  // (tap, shift) weight planes

template <int OT>
struct Tile {
  static constexpr int OG = OT / 4;         // threads across outputs, 4 outputs each
  static constexpr int PG = NT / OG;        // threads across pixels
  static constexpr int PPT = NP / PG;       // pixels per thread
  static_assert(OT % 4 == 0 && NT % OG == 0 && NP % PG == 0 && PPT % 4 == 0,
                "tile shape");
  static constexpr size_t smem_floats =
      NPLANE * NP + CK * XS_STRIDE + CK * NP + CK * OT;
  static constexpr size_t smem_bytes = smem_floats * sizeof(float);
};

template <int OT>
__global__ void __launch_bounds__(NT)
ric_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                    const float* __restrict__ swf, float* __restrict__ out,
                    int H, int W, int C, int O, int o_tiles) {
  using T = Tile<OT>;
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                        // [t*9+i][NP]: swf[i,t,p+off_i], 0 if source outside
  float* xs = wsm + NPLANE * NP;            // [CK][XS_STRIDE]: x halo tile
  float* us = xs + CK * XS_STRIDE;          // [CK][NP]: bilinear samples u_t
  float* ws = us + CK * NP;                 // [CK][OT]: wk[t] chunk

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / o_tiles;
  const int o0 = (blockIdx.z % o_tiles) * OT;
  const size_t hw = static_cast<size_t>(H) * W;
  const float* xn = x + static_cast<size_t>(n) * hw * C;

  // Per-pixel tap weights, once per block.
  for (int e = tid; e < NPLANE * NP; e += NT) {
    const int p = e % NP;
    const int plane = e / NP;
    const int t = plane / 9;
    const int i = plane % 9;
    const int py = ty0 + p / TW;
    const int px = tx0 + p % TW;
    const int qy = py + i / 3 - 1;
    const int qx = px + i % 3 - 1;
    float v = 0.f;
    if ((t != 4 || i == 4) && py < H && px < W && qy >= 0 && qy < H &&
        qx >= 0 && qx < W)
      v = swf[static_cast<size_t>(i * 9 + t) * hw + static_cast<size_t>(qy) * W + qx];
    wsm[e] = v;
  }

  const int og = tid % T::OG;
  const int pg = tid / T::OG;
  float acc[T::PPT][4];
#pragma unroll
  for (int j = 0; j < T::PPT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // previous chunk's readers of xs are done
    for (int e = tid; e < CK * HALO; e += NT) {
      const int c = e % CK;
      const int cell = e / CK;
      const int gy = ty0 - 1 + cell / HALO_W;
      const int gx = tx0 - 1 + cell % HALO_W;
      float v = 0.f;
      if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xn[(static_cast<size_t>(gy) * W + gx) * C + c0 + c];
      xs[c * XS_STRIDE + cell] = v;
    }
    for (int t = 0; t < 9; ++t) {
      __syncthreads();  // xs is ready; previous tap's readers of us/ws are done
      // Each thread samples one pixel for CK / (NT / NP) channels, so its
      // nine tap weights are read from shared memory once per tap.
      {
        const int p = tid % NP;
        const float* wt = wsm + t * 9 * NP + p;
        const float* xp = xs + (p / TW + 1) * HALO_W + p % TW + 1;
        if (t == 4) {
          const float wc = wt[4 * NP];  // center tap: only the center shift
          for (int c = tid / NP; c < CK; c += NT / NP)
            us[c * NP + p] = wc * xp[c * XS_STRIDE];
        } else {
          float wr[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) wr[i] = wt[i * NP];
          for (int c = tid / NP; c < CK; c += NT / NP) {
            const float* xr = xp + c * XS_STRIDE;
            float u = 0.f;
#pragma unroll
            for (int i = 0; i < 9; ++i)
              u = fmaf(wr[i], xr[(i / 3 - 1) * HALO_W + i % 3 - 1], u);
            us[c * NP + p] = u;
          }
        }
      }
      for (int e = tid; e < CK * OT; e += NT) {
        const int o = e % OT;
        const int c = e / OT;
        float v = 0.f;
        if (c0 + c < C && o0 + o < O)
          v = wk[(static_cast<size_t>(t) * C + c0 + c) * O + o0 + o];
        ws[e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + c * OT + og * 4);
#pragma unroll
        for (int j4 = 0; j4 < T::PPT; j4 += 4) {
          const float4 uv =
              *reinterpret_cast<const float4*>(us + c * NP + pg * T::PPT + j4);
          const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j4 + j][0] = fmaf(u4[j], wv.x, acc[j4 + j][0]);
            acc[j4 + j][1] = fmaf(u4[j], wv.y, acc[j4 + j][1]);
            acc[j4 + j][2] = fmaf(u4[j], wv.z, acc[j4 + j][2]);
            acc[j4 + j][3] = fmaf(u4[j], wv.w, acc[j4 + j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < T::PPT; ++j) {
    const int p = pg * T::PPT + j;
    const int py = ty0 + p / TW;
    const int px = tx0 + p % TW;
    if (py >= H || px >= W) continue;
    float* op = out + ((static_cast<size_t>(n) * H + py) * W + px) * O;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = o0 + og * 4 + k;
      if (o < O) op[o] = acc[j][k];
    }
  }
}

template <int OT>
int launch(const float* x, const float* wk, const float* swf, float* out,
           int n, int h, int w, int c, int o, cudaStream_t stream) {
  constexpr size_t smem = Tile<OT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ric_conv_fwd_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int o_tiles = (o + OT - 1) / OT;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n * o_tiles);
  ric_conv_fwd_kernel<OT><<<grid, NT, smem, stream>>>(x, wk, swf, out, h, w, c,
                                                      o, o_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (the Python wrapper validates shapes, types, devices and
// contiguity). Returns the cudaError_t of the launch: 0 on success.
extern "C" int ric_conv_fwd_launch(const float* x, const float* wk,
                                   const float* swf, float* out, int n, int h,
                                   int w, int c, int o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o <= 32) return launch<32>(x, wk, swf, out, n, h, w, c, o, s);
  return launch<64>(x, wk, swf, out, n, h, w, c, o, s);
}

extern "C" const char* ric_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
