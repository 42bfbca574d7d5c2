// Rotation-invariant 3x3 conv (RIC conv), backward (VJP), f32, for sm_90a.
//
// Replaces the Pallas TPU kernel drawingspinup_tpu/kernels/ric_conv.py::
// _bwd_kernel (driven by _bwd_call, the custom VJP of ric_conv). Same math,
// with off_i the offset of shift i = (sy,sx) = (i/3-1, i%3-1) and [.] for
// "inside the image":
//
//   dz_t[n,q,:] = sum_i swf[i,t,q] * [q-off_i] * g[n,q-off_i,:]
//   dx[n,q,:]   = sum_t dz_t[n,q,:] @ wk[t]^T             (contract O)
//   dwk[t]      = sum_{n,q} x[n,q,:]^T (x) dz_t[n,q,:]     (contract pixels)
//
// with x (N,H,W,C), wk (9,C,O), swf (9 shifts, 9 taps, H, W), g (N,H,W,O),
// all f32 and contiguous; dx (N,H,W,C), dwk (9,C,O). No gradient to swf.
//
// What bounds it on the card: arithmetic, as in the forward. Each of dx and
// dwk is 9*C*O FMAs per pixel of channel matmul, against ~(C + O + 81)
// floats of traffic; the sampling of g (73*O FMAs per pixel and tap set)
// is recomputed per C tile in dx, ~10% extra at C = 64.
// The TPU kernel kept nine whole-block (rows, O) cotangent copies and the
// (9,C,O) gradient resident in VMEM across a sequential grid; here blocks
// run in parallel, so:
//
//   * dx: a block owns an 8x16 pixel tile and CT (32 or 64) input
//     channels, walks O in chunks of 16 with a one-pixel halo of g in
//     shared memory, builds dz_t there (sampling with the unshifted swf at
//     q), and accumulates dz_t @ wk[t]^T in a per-thread register tile, as
//     the forward kernel does. Every dx element has one owner.
//   * dwk: three launches. The first samples dz_t for every tap once into
//     an (N*H*W, 9, O) scratch (8x16 pixel tile, 32 channels a block, g
//     halo and weight planes in shared memory). The second is a split-K
//     product x^T dz over fixed pixel slices: a 64 x 128 tile of the
//     (C, 9*O) result per block, 16 pixels per double-buffered stage, a
//     4 x 8 register tile per thread, each slice's sum to scratch. The
//     third adds the slices in index order and permutes to (9, C, O). No
//     float atomics anywhere, so runs are bit-identical. The scratch trip
//     costs ~2 x 4*9*O bytes per pixel of device memory traffic, cheap on
//     an H100 and far less than resampling g per (tap, channel tile).
//   * Out-of-image sources are never read: their halo cells and weights are
//     zeros, so a non-finite g there gives hard zeros, as the TPU kernel's
//     where() does. The 8 (tap 4, shift != 4) planes, zero by construction,
//     are skipped (the TPU kernel's _active).
//   * Plain f32 FMA and f32 accumulation, no TF32. Speed is for later work:
//     at 8x8 images (conv2 and the 14 resnet convs) the 8x16 tile is half
//     empty.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TH = 8;                       // pixel tile rows
constexpr int TW = 16;                      // pixel tile cols
constexpr int NP = TH * TW;                 // pixels per tile
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;     // halo tile cells
constexpr int GS_STRIDE = HALO + 1;         // odd stride: channel rows spread over banks
constexpr int OK = 16;                      // cotangent channels per chunk
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

// gs[o * GS_STRIDE + cell] = g[n, cell, o0 + o], zero outside the image and
// past O.
__device__ __forceinline__ void load_g_halo(const float* __restrict__ gn,
                                            float* gs, int ty0, int tx0,
                                            int o0, int H, int W, int O,
                                            int tid) {
  for (int e = tid; e < OK * HALO; e += NT) {
    const int o = e % OK;
    const int cell = e / OK;
    const int gy = ty0 - 1 + cell / HALO_W;
    const int gx = tx0 - 1 + cell % HALO_W;
    float v = 0.f;
    if (o0 + o < O && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = gn[(static_cast<size_t>(gy) * W + gx) * O + o0 + o];
    gs[o * GS_STRIDE + cell] = v;
  }
}

// ---------------------------------------------------------------- dx ----

template <int CT>
struct DxTile {
  static constexpr int CG = CT / 4;         // threads across channels, 4 each
  static constexpr int PG = NT / CG;        // threads across pixels
  static constexpr int PPT = NP / PG;       // pixels per thread
  static constexpr int WS_STRIDE = CT + 4;  // keeps float4 rows, spreads banks
  static_assert(CT % 4 == 0 && NT % CG == 0 && NP % PG == 0 && PPT % 4 == 0,
                "tile shape");
  static constexpr size_t smem_floats =
      NPLANE * NP + OK * GS_STRIDE + OK * NP + OK * WS_STRIDE;
  static constexpr size_t smem_bytes = smem_floats * sizeof(float);
};

template <int CT>
__global__ void __launch_bounds__(NT)
ric_conv_dx_kernel(const float* __restrict__ g, const float* __restrict__ wk,
                   const float* __restrict__ swf, float* __restrict__ dx,
                   int H, int W, int C, int O, int c_tiles) {
  using T = DxTile<CT>;
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                        // [t*9+i][NP]: swf[i,t,q], 0 if source outside
  float* gs = wsm + NPLANE * NP;            // [OK][GS_STRIDE]: g halo tile
  float* dzs = gs + OK * GS_STRIDE;         // [OK][NP]: dz_t for the chunk
  float* ws = dzs + OK * NP;                // [OK][WS_STRIDE]: wk[t] chunk, transposed

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / c_tiles;
  const int c0 = (blockIdx.z % c_tiles) * CT;
  const size_t hw = static_cast<size_t>(H) * W;
  const float* gn = g + static_cast<size_t>(n) * hw * O;

  for (int e = tid; e < NPLANE * NP; e += NT) {
    const int p = e % NP;
    const int plane = e / NP;
    wsm[e] = plane_weight(swf, plane / 9, plane % 9, ty0 + p / TW,
                          tx0 + p % TW, H, W);
  }

  const int cg = tid % T::CG;
  const int pg = tid / T::CG;
  float acc[T::PPT][4];
#pragma unroll
  for (int j = 0; j < T::PPT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int o0 = 0; o0 < O; o0 += OK) {
    __syncthreads();  // previous chunk's readers of gs are done
    load_g_halo(gn, gs, ty0, tx0, o0, H, W, O, tid);
    for (int t = 0; t < 9; ++t) {
      __syncthreads();  // gs is ready; previous tap's readers of dzs/ws are done
      {
        // dz_t[q] = sum_i w[i][q] * g[q - off_i]: each thread samples one
        // pixel for OK / (NT / NP) channels, its weights held in registers
        const int p = tid % NP;
        const float* wt = wsm + t * 9 * NP + p;
        const float* gp = gs + (p / TW + 1) * HALO_W + p % TW + 1;
        if (t == 4) {
          const float wc = wt[4 * NP];  // center tap: only the center shift
          for (int o = tid / NP; o < OK; o += NT / NP)
            dzs[o * NP + p] = wc * gp[o * GS_STRIDE];
        } else {
          float wr[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) wr[i] = wt[i * NP];
          for (int o = tid / NP; o < OK; o += NT / NP) {
            const float* gr = gp + o * GS_STRIDE;
            float u = 0.f;
#pragma unroll
            for (int i = 0; i < 9; ++i)
              u = fmaf(wr[i], gr[-(i / 3 - 1) * HALO_W - (i % 3 - 1)], u);
            dzs[o * NP + p] = u;
          }
        }
      }
      for (int e = tid; e < OK * CT; e += NT) {
        const int o = e % OK;
        const int c = e / OK;
        float v = 0.f;
        if (c0 + c < C && o0 + o < O)
          v = wk[(static_cast<size_t>(t) * C + c0 + c) * O + o0 + o];
        ws[o * T::WS_STRIDE + c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < OK; ++o) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + o * T::WS_STRIDE + cg * 4);
#pragma unroll
        for (int j4 = 0; j4 < T::PPT; j4 += 4) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dzs + o * NP + pg * T::PPT + j4);
          const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j4 + j][0] = fmaf(d4[j], wv.x, acc[j4 + j][0]);
            acc[j4 + j][1] = fmaf(d4[j], wv.y, acc[j4 + j][1]);
            acc[j4 + j][2] = fmaf(d4[j], wv.z, acc[j4 + j][2]);
            acc[j4 + j][3] = fmaf(d4[j], wv.w, acc[j4 + j][3]);
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
    float* dp = dx + ((static_cast<size_t>(n) * H + py) * W + px) * C;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + cg * 4 + k;
      if (c < C) dp[c] = acc[j][k];
    }
  }
}

// --------------------------------------------------------------- dwk ----

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

// Split-K product part[s] = x[P_s, C]^T dz[P_s, 9*O] over the slice P_s of
// the N*H*W pixels: a block owns a 64 x 128 tile of the (C, 9*O) result and
// walks its slice 16 pixels at a time through double-buffered shared tiles;
// each thread keeps a 4 x 8 register tile (its 8 columns in two runs of 4,
// so that a warp's float4 loads are contiguous).
constexpr int GM = 64;                      // rows (input channels) per block
constexpr int GN = 128;                     // columns (tap, output) per block
constexpr int GK = 16;                      // pixels per stage
static_assert((GM / 4) * (GN / 8) == NT, "dwk tile shape");

__global__ void __launch_bounds__(NT)
ric_conv_dwk_gemm_kernel(const float* __restrict__ x,
                         const float* __restrict__ dz,
                         float* __restrict__ part, long long P, int C, int J,
                         int slices) {
  __shared__ __align__(16) float xs[2][GK][GM];
  __shared__ __align__(16) float ds[2][GK][GN];
  constexpr int XL = GK * GM / NT;          // staged loads per thread
  constexpr int DL = GK * GN / NT;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * GN;
  const int c0 = blockIdx.y * GM;
  const int s = blockIdx.z;
  const long long p_begin = P * s / slices;
  const long long p_end = P * (s + 1) / slices;
  const int tj = tid % (GN / 8);
  const int tc = tid / (GN / 8);

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  float xr[XL], dr[DL];
  auto load = [&](long long p0) {
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int e = tid + r * NT;
      const long long p = p0 + e / GM;
      const int c = c0 + e % GM;
      xr[r] = (p < p_end && c < C) ? x[p * C + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < DL; ++r) {
      const int e = tid + r * NT;
      const long long p = p0 + e / GN;
      const int j = j0 + e % GN;
      dr[r] = (p < p_end && j < J) ? dz[p * J + j] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int e = tid + r * NT;
      xs[buf][e / GM][e % GM] = xr[r];
    }
#pragma unroll
    for (int r = 0; r < DL; ++r) {
      const int e = tid + r * NT;
      ds[buf][e / GN][e % GN] = dr[r];
    }
  };

  int buf = 0;
  load(p_begin);
  store(buf);
  __syncthreads();
  for (long long p0 = p_begin; p0 < p_end; p0 += GK) {
    const bool more = p0 + GK < p_end;
    if (more) load(p0 + GK);                // in flight during the products
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[buf][k][tc * 4]);
      const float4 d0 = *reinterpret_cast<const float4*>(&ds[buf][k][tj * 4]);
      const float4 d1 =
          *reinterpret_cast<const float4*>(&ds[buf][k][GN / 2 + tj * 4]);
      const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
      const float d8[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(x4[a], d8[b], acc[a][b]);
    }
    if (more) store(buf ^ 1);               // the other buffer: nobody reads it
    __syncthreads();
    buf ^= 1;
  }

  float* out = part + static_cast<size_t>(s) * C * J;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = c0 + tc * 4 + a;
    if (c >= C) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b < 4 ? tj * 4 + b : GN / 2 + tj * 4 + b - 4);
      if (j < J) out[static_cast<size_t>(c) * J + j] = acc[a][b];
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

template <int CT>
int launch_dx(const float* g, const float* wk, const float* swf, float* dx,
              int n, int h, int w, int c, int o, cudaStream_t stream) {
  constexpr size_t smem = DxTile<CT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ric_conv_dx_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c_tiles = (c + CT - 1) / CT;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n * c_tiles);
  ric_conv_dx_kernel<CT><<<grid, NT, smem, stream>>>(g, wk, swf, dx, h, w, c,
                                                     o, c_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (the Python wrapper validates shapes, types, devices and
// contiguity, and allocates dx, dwk and the scratch). Each returns the
// cudaError_t of its launches: 0 on success.
extern "C" int ric_conv_bwd_dx_launch(const float* g, const float* wk,
                                      const float* swf, float* dx, int n,
                                      int h, int w, int c, int o,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) return launch_dx<32>(g, wk, swf, dx, n, h, w, c, o, s);
  return launch_dx<64>(g, wk, swf, dx, n, h, w, c, o, s);
}

// dz: (N*H*W, 9, O) floats of scratch for the sampled cotangent; slices:
// how many fixed pixel slices the product is cut into; scratch: (slices, C,
// 9*O) floats of partial sums.
extern "C" int ric_conv_bwd_dwk_launch(const float* x, const float* g,
                                       const float* swf, float* dz,
                                       float* scratch, float* dwk, int n,
                                       int h, int w, int c, int o, int slices,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slices < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ric_conv_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DZ_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int o_chunks = (o + OZ - 1) / OZ;
  const dim3 zgrid((w + TW - 1) / TW, (h + TH - 1) / TH, n * o_chunks);
  ric_conv_dz_kernel<<<zgrid, NT, DZ_SMEM_BYTES, st>>>(g, swf, dz, h, w, o,
                                                       o_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int j = 9 * o;
  const dim3 ggrid((j + GN - 1) / GN, (c + GM - 1) / GM, slices);
  ric_conv_dwk_gemm_kernel<<<ggrid, NT, 0, st>>>(
      x, dz, scratch, static_cast<long long>(n) * h * w, c, j, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ric_conv_dwk_reduce_kernel<<<(9 * c * o + 255) / 256, 256, 0, st>>>(
      scratch, dwk, c, o, slices);
  return static_cast<int>(cudaGetLastError());
}
