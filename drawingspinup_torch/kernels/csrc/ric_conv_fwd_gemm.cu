// Rotation-invariant 3x3 conv (RIC conv), forward, f32-accurate (3xTF32)
// on the tensor cores, for sm_90a.
//
// Replaces the Pallas TPU kernel drawingspinup_tpu/kernels/ric_conv.py::
// _fwd_kernel (driven by _fwd_call, exposed as ric_conv). Same function:
// x (N,H,W,C), wk (9,C,O), swf (9 shifts, 9 taps, H, W), all f32 and
// contiguous, out (N,H,W,O) f32, with shift i = (sy,sx) = (i/3-1, i%3-1).
// The TPU kernel multiplies first (nine tap products x.wk[t] of whole
// images resident in VMEM) and mixes per pixel after. Here the order is
// reversed, so that the whole conv is one implicit GEMM over P = N*H*W
// pixels:
//
//   out (P x O) = U (P x 9C) . Wk (9C x O),
//   U[p, t*C + c] = u_t[p, c] = sum_i valid_i(p) * swf[i,t,p+off_i] * x[p+off_i, c]
//
// (swf[i,t,p+off_i] is generator_j.py::ric_shifted_weights' sw[t,i,p]). U is
// sampled in shared memory and never reaches device memory: 73*C FMAs a
// pixel once (the 8 planes of tap 4 under a non-center shift are zero and
// skipped, the TPU kernel's _active), against 9*C*O products.
//
// What bounds it on the card: operations. A 512^2 GeneratorJ_RIC frame is
// 297.5 GFLOP of channel products; at three TF32 products per f32 product
// (495 TFLOP/s of TF32) that is 1.83 ms, against ~1.6 GB of x, swf, wk and
// out (0.47 ms at 3.35 TB/s). In f32 outside the tensor cores it would be
// 4.46 ms, which no SIMT kernel can beat. What the design does about it:
//
//   * The products run on wgmma.mma_async m64nBNk8 .tf32, both operands in
//     shared memory, K-major, in the no-swizzle core-matrix layout (8 rows
//     x 16 bytes per 128-byte core matrix; LBO 128 B between the two core
//     matrices of a k-step, SBO 1 KB between 8-row groups; the 128-byte
//     swizzled layout measured no faster). Every f32 operand v is split
//     once, when its tile is built, into hi = rna(v) and lo = rna(v - hi),
//     rna rounding to TF32 as cvt.rna.tf32.f32 does; a stage (one tap of
//     one 32-channel chunk, always 4 k-steps: A and B are zero past C)
//     issues lo.hi, hi.lo, then hi.hi per k-step into a fresh f32
//     accumulator, which is then added to the running sum by rounded f32
//     adds: the tensor cores' chained accumulation truncates, and a chain
//     of at most 12 products keeps that below the f32 sum's own rounding.
//     No plain-TF32 path and no SIMT path exist.
//   * A block owns an 8x8 pixel tile of one image (64 rows, one wgmma M) and
//     BN = 32, 64 or 128 output channels (all of O on the main path, so
//     each pixel is sampled once). Its 384 threads are three warpgroups
//     around a ring of 3 (BN = 128) or 4 stages in shared memory:
//     - two producer warpgroups stage the x halo (10x10 cells x 32
//       channels, cp.async, 16-byte copies where C % 4 == 0, else 4-byte,
//       zero-filled outside the image by the copy's source size,
//       double-buffered across chunks) and the tile's 81 tap-weight planes
//       (4-byte cp.async, so that no load waits on another); each thread
//       keeps the 3x3 neighbourhood of its (pixel, 8 channels) item in
//       registers for the whole chunk, and per tap samples and splits it,
//       writing hi and lo once, in the layout the tensor cores read;
//     - the B tile of a stage is a contiguous 2 x BN x 32 image of wk[t]'s
//       chunk, split into hi and lo once per call by a pre-pass
//       (ric_conv_fwd_split_kernel) and brought in by one bulk copy (the
//       TMA engine) that completes the slot's mbarrier;
//     - the consumer warpgroup waits for a slot's A (a named barrier the
//       producers arrive at, after fence.proxy.async) and B (the
//       mbarrier), issues its products, and once they are done releases
//       the slot (a named barrier the producers wait at) and adds them.
//     The compiler serialises every wgmma of a warpgroup (ptxas's C7514,
//     C7515 and C7520 advisories: each product then waits for the one
//     before) if they are issued on a path it takes for divergent, or if
//     any other instruction touches an accumulator while products are in
//     flight: hence the role from a shuffle, the 4 k-steps without a
//     branch, and one accumulator, waited for before it is read (two in
//     turn, or a copy, were serialised).
//     Measured on an H100 (PERF.md, kernels/ric_fwd_anatomy.py): the copies
//     and hand-offs alone take about half the time, and leaving out the
//     sampling or the products saves only 14-18 % at the widest layer:
//     they limit together. The kernel reaches ~45 % of the operation bound
//     at the widest layers and less at the narrow ones.
//   * Where the tiles alone do not fill the card (the 8^2 training patches:
//     40 tiles at N = 40), the stages (chunk-major, tap-minor) are cut into
//     fixed slices (blockIdx.z), each written to its own partial buffer and
//     summed in slice order by ric_conv_bwd.cu's ordered sum: no float
//     atomics, so two launches give the same bits. kernels/ric_conv.py::
//     fwd_plan plans BN and the slices from the shape alone; the launcher
//     refuses any other plan.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

extern "C" int ric_conv_bwd_sum_slices_launch(const float* part, float* out,
                                              long long elems, int slices,
                                              void* stream);

namespace {

constexpr int TILE = 8;                     // pixel tile side
constexpr int BM = TILE * TILE;             // 64 pixels: one wgmma M
constexpr int CK = 32;                      // channels per chunk
constexpr int HALO_W = TILE + 2;
constexpr int HALO = HALO_W * HALO_W;       // halo cells
constexpr int CELL = CK + 4;                // floats per halo cell (padded)
constexpr int NPLANE = 81;                  // (tap, shift) weight planes
constexpr int MAX_RING = 4;                 // stages in flight, at most
constexpr int NT = 384;                     // a consumer, two producer warpgroups
constexpr int WG = 128;                     // threads per warpgroup
constexpr int PT = NT - WG;                 // producer threads
static_assert(PT * 8 == BM * CK, "a (pixel, 8 channels) item a producer");
constexpr int CORE = 32;                    // floats per 8 x 4 core matrix
constexpr int GROUP = CK / 4 * CORE;        // floats per 8-row group (SBO)
constexpr int A_FLOATS = BM * CK;           // one of A's hi / lo
// Measurement switches, on in every build the port makes:
// kernels/ric_fwd_anatomy.py builds the kernel without its sampling or
// without its products (outputs then wrong) to time what is left.
#ifdef RIC_FWD_NO_SAMPLING
constexpr bool SAMPLING = false;
#else
constexpr bool SAMPLING = true;
#endif
#ifdef RIC_FWD_NO_PRODUCTS
constexpr bool PRODUCTS = false;
#else
constexpr bool PRODUCTS = true;
#endif
// named barriers (0 is __syncthreads')
constexpr int BAR_FULL = 1;                 // + slot
constexpr int BAR_EMPTY = BAR_FULL + MAX_RING;  // + slot
constexpr int BAR_PROD = BAR_EMPTY + MAX_RING;  // the producer warpgroups alone

template <int BN>
struct Layout {
  // stages in flight: as many as fit beside the halo and the tap weights
  static constexpr int RING = BN == 128 ? 3 : 4;
  static constexpr int B_FLOATS = BN * CK;  // one of B's hi / lo
  static constexpr int SLOT = 2 * A_FLOATS + 2 * B_FLOATS;
  static constexpr int HALO_OFF = RING * SLOT;
  static constexpr int WSM_OFF = HALO_OFF + 2 * HALO * CELL;
  static constexpr int MBAR_OFF = WSM_OFF + NPLANE * BM;  // 8-byte aligned
  static constexpr size_t BYTES =
      static_cast<size_t>(MBAR_OFF) * sizeof(float) + RING * sizeof(uint64_t);
};

// Float offset of element (row r, k) in a K-major tile of 8-row groups.
__device__ __forceinline__ int tile_offset(int r, int k) {
  return (r / 8) * GROUP + (k / 4) * CORE + (r % 8) * 4 + k % 4;
}

// Round to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from zero,
// the low 13 bits cleared), in two integer ops at full rate.
__device__ __forceinline__ float rna_tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// v = hi + lo + O(2^-22 |v|), hi and lo TF32 values (low 13 bits zero).
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - hi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy V floats (16 bytes for V = 4, 4 for V = 1) into shared memory; the
// first `valid` are read from src, the rest zero-filled. src must be a valid
// address even when valid == 0.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid) {
  const uint32_t d = smem_addr(dst);
  const int bytes = valid * 4;
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The generic-proxy writes (st.shared) before this are ordered before later
// async-proxy reads (wgmma) of the same shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One bulk copy (the TMA engine) of `bytes` from global src to shared dst,
// completing a phase of the mbarrier bar, which expects those bytes.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major no-swizzle tile at p: start
// address, LBO (the next core matrix along K) 128 B, SBO (the next 8-row
// group) GROUP floats, all in 16-byte units; layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((CORE * 4) >> 4) << 16) |
         (static_cast<uint64_t>((GROUP * 4) >> 4) << 32);
}

// A k-step (8 TF32 values, two core matrices) further along K.
constexpr uint64_t KSTEP_DESC = (2 * CORE * 4) >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (+)= a (64 x 8) . b (8 x 32): TF32 operands in shared memory
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= a (64 x 8) . b (8 x 64): TF32 operands in shared memory
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= a (64 x 8) . b (8 x 128): TF32 operands in shared memory
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// Stage the x halo of one chunk: cells (ty0-1 .. ty0+8, tx0-1 .. tx0+8),
// channels c0 .. c0+depth, zero outside the image and past C.
template <int V>
__device__ __forceinline__ void load_halo(float* hb,
                                          const float* __restrict__ xn, int H,
                                          int W, int C, int ty0, int tx0,
                                          int c0, int depth, int pt) {
  const int per_cell = depth / V;
  for (int e = pt; e < HALO * per_cell; e += PT) {
    const int cell = e / per_cell;
    const int c = (e % per_cell) * V;
    const int gy = ty0 - 1 + cell / HALO_W;
    const int gx = tx0 - 1 + cell % HALO_W;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
    cp_async<V>(hb + cell * CELL + c,
                in ? xn + (static_cast<size_t>(gy) * W + gx) * C + c0 + c : xn,
                in ? V : 0);
  }
}

// Channels a chunk's products cover: its channels, rounded up to a k-step.
__device__ __forceinline__ int chunk_depth(int chunk, int C) {
  const int rest = C - chunk * CK;
  return rest >= CK ? CK : (rest + 7) / 8 * 8;
}

struct Block {
  int H, W, C, O;
  int img, ty0, tx0, o_tile;
  int s0, s1, stages;
};

// Bulk-copy stage s's B image (hi, then lo) into ring slot `slot`.
template <int BN>
__device__ __forceinline__ void load_b(float* smem,
                                       const float* __restrict__ wsplit,
                                       const Block& bk, int s, int slot) {
  using L = Layout<BN>;
  const float* src =
      wsplit + (static_cast<size_t>(bk.o_tile) * bk.stages + s) * 2 *
                   L::B_FLOATS;
  const uint64_t* mbar = reinterpret_cast<const uint64_t*>(smem + L::MBAR_OFF);
  bulk_copy(smem_addr(smem + slot * L::SLOT + 2 * A_FLOATS), src,
            2 * L::B_FLOATS * sizeof(float), smem_addr(mbar + slot));
}

// The producer warpgroups: halo and tap weights in, U's tiles out; thread 0
// also starts each stage's B copy once its slot is free.
template <int BN, int VX>
__device__ __forceinline__ void produce(const Block& bk, float* smem,
                                        const float* __restrict__ x,
                                        const float* __restrict__ wsplit,
                                        const float* __restrict__ swf,
                                        int pt) {
  using L = Layout<BN>;
  float* halo = smem + L::HALO_OFF;
  float* wsm = smem + L::WSM_OFF;           // [t*9+i][BM]
  const int H = bk.H, W = bk.W, C = bk.C;
  const size_t hw = static_cast<size_t>(H) * W;

  // Warp w takes tile row w, lanes 8k..8k+7 its eight pixels, so that halo
  // reads and tile writes stay on distinct banks: each thread owns
  // channels c8 .. c8+7 of the chunk at pixel m.
  const int m = 8 * (pt / 32) + pt % 8;
  const int c8 = 8 * ((pt / 8) % 4);

  // The tap weights, zero where the plane is inactive or the pixel or its
  // source lies outside the image: copies, so that none waits on another.
  for (int e = pt; e < NPLANE * BM; e += PT) {
    const int plane = e / BM;
    const int t = plane / 9;
    const int i = plane % 9;
    const int py = bk.ty0 + (e % BM) / TILE;
    const int px = bk.tx0 + e % TILE;
    const int qy = py + i / 3 - 1;
    const int qx = px + i % 3 - 1;
    const bool in = (t != 4 || i == 4) && py < H && px < W && qy >= 0 &&
                    qy < H && qx >= 0 && qx < W;
    cp_async<1>(wsm + e,
                in ? swf + static_cast<size_t>(i * 9 + t) * hw +
                         static_cast<size_t>(qy) * W + qx
                   : swf,
                in ? 1 : 0);
  }
  // The ring: slot j % R holds stage j's A (written here) and B (one bulk
  // copy by thread 0, completing the slot's mbarrier). A slot is refilled
  // once the consumer has released it, so the producers run up to R
  // stages ahead.
  constexpr int R = L::RING;
  const int nst = bk.s1 - bk.s0;
  const float* xn = x + static_cast<size_t>(bk.img) * hw * C;
  {
    const int chunk = bk.s0 / 9;
    load_halo<VX>(halo + (chunk & 1) * HALO * CELL, xn, H, W, C, bk.ty0,
                  bk.tx0, chunk * CK, chunk_depth(chunk, C), pt);
    cp_async_commit();
    if (pt == 0)
      for (int j = 0; j < R && j < nst; ++j)
        load_b<BN>(smem, wsplit, bk, bk.s0 + j, j);
  }

  float4 nb[9][2];                          // the 3x3 neighbourhood
  int depth = 0;
  for (int j = 0; j < nst; ++j) {
    const int s = bk.s0 + j;
    const int chunk = s / 9;
    const int t = s % 9;
    const int slot = j % R;
    const bool chunk_start = j == 0 || t == 0;
    float* sl = smem + slot * L::SLOT;
    if (chunk_start) {
      cp_async_wait<0>();
      bar_sync(BAR_PROD, PT);               // the halo and weights are in
      depth = chunk_depth(chunk, C);
      const float* ctr = halo + (chunk & 1) * HALO * CELL +
                         ((m / TILE + 1) * HALO_W + m % TILE + 1) * CELL + c8;
      if (c8 < depth) {
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            nb[i][h] = *reinterpret_cast<const float4*>(
                ctr + ((i / 3 - 1) * HALO_W + i % 3 - 1) * CELL + 4 * h);
      }
    }
    if (j >= R) {
      bar_sync(BAR_EMPTY + slot, NT);       // the consumer has released it
      if (pt == 0) load_b<BN>(smem, wsplit, bk, s, slot);
    }
    if (SAMPLING) {
      // past C (depth is a whole number of k-steps): zeros
      float u[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c8 < depth) {
        const float* wp = wsm + t * 9 * BM + m;
        if (t == 4) {                       // center tap: center shift only
          const float wc = wp[4 * BM];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            u[4 * h] = wc * nb[4][h].x;
            u[4 * h + 1] = wc * nb[4][h].y;
            u[4 * h + 2] = wc * nb[4][h].z;
            u[4 * h + 3] = wc * nb[4][h].w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            const float wi = wp[i * BM];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              u[4 * h] = fmaf(wi, nb[i][h].x, u[4 * h]);
              u[4 * h + 1] = fmaf(wi, nb[i][h].y, u[4 * h + 1]);
              u[4 * h + 2] = fmaf(wi, nb[i][h].z, u[4 * h + 2]);
              u[4 * h + 3] = fmaf(wi, nb[i][h].w, u[4 * h + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 hi, lo;
        split_tf32(u[4 * h], hi.x, lo.x);
        split_tf32(u[4 * h + 1], hi.y, lo.y);
        split_tf32(u[4 * h + 2], hi.z, lo.z);
        split_tf32(u[4 * h + 3], hi.w, lo.w);
        const int off = tile_offset(m, c8 + 4 * h);
        *reinterpret_cast<float4*>(sl + off) = hi;
        *reinterpret_cast<float4*>(sl + A_FLOATS + off) = lo;
      }
    }
    fence_proxy_async();                    // A's stores, then wgmma's reads
    bar_arrive(BAR_FULL + slot, NT);        // (which orders them for the consumer)
    if (chunk_start && (chunk + 1) * 9 < bk.s1) {  // the other buffer is free
      load_halo<VX>(halo + ((chunk + 1) & 1) * HALO * CELL, xn, H, W, C,
                    bk.ty0, bk.tx0, (chunk + 1) * CK,
                    chunk_depth(chunk + 1, C), pt);
      cp_async_commit();
    }
  }
}

// Wait for stage j's A (the producer's arrival) and B (its bulk copy);
// returns the stage's ring slot.
template <int BN>
__device__ __forceinline__ const float* stage_ready(const float* smem, int j) {
  using L = Layout<BN>;
  const int slot = j % L::RING;
  const uint64_t* mbar = reinterpret_cast<const uint64_t*>(smem + L::MBAR_OFF);
  bar_sync(BAR_FULL + slot, NT);
  mbar_wait(smem_addr(mbar + slot), (j / L::RING) & 1);
  return smem + slot * L::SLOT;
}

// Issue a stage's products, lo.hi + hi.lo + hi.hi of every k-step, into the
// fresh accumulator d, as one wgmma group.
template <int BN>
__device__ __forceinline__ void issue_stage(float (&d)[BN / 2], const float* sl) {
  const uint64_t ah = smem_desc(sl);
  const uint64_t al = smem_desc(sl + A_FLOATS);
  const uint64_t bh = smem_desc(sl + 2 * A_FLOATS);
  const uint64_t bl = smem_desc(sl + 2 * A_FLOATS + Layout<BN>::B_FLOATS);
  fence_regs(d);
  wgmma_fence();
  if constexpr (PRODUCTS) {
#pragma unroll
    for (int kk = 0; kk < CK / 8; ++kk) {
      const uint64_t k = kk * KSTEP_DESC;
      Wgmma<BN>::run(d, al + k, bh + k, kk > 0);
      Wgmma<BN>::run(d, ah + k, bl + k, 1);
      Wgmma<BN>::run(d, ah + k, bh + k, 1);
    }
  }
  wgmma_commit();
}

// The consumer warpgroup: per stage, the products into a fresh
// accumulator, then, once they are done, the stage's slot released and
// one rounded add into the running sum. The accumulator is read only after
// the wait for every product in flight: the compiler serialises all the
// products of a warpgroup that reads accumulator registers while any are
// in flight. At the end the 64 x BN tile to dst.
template <int BN>
__device__ __forceinline__ void consume(const Block& bk, const float* smem,
                                        float* __restrict__ dst, int tid) {
  constexpr int R = Layout<BN>::RING;
  constexpr int NR = BN / 2;
  const int nst = bk.s1 - bk.s0;
  float acc[NR], d[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = d[r] = 0.f;
  for (int j = 0; j < nst; ++j) {
    issue_stage<BN>(d, stage_ready<BN>(smem, j));
    wgmma_wait<0>();
    fence_regs(d);
    if (j + R < nst) bar_arrive(BAR_EMPTY + j % R, NT);
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] += d[r];
  }

  // d fragment: warp w holds rows 16w .. 16w+15; register 4*jn + 2*h + e is
  // (row 16w + lane/4 + 8h, column 8*jn + 2*(lane%4) + e)
  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + lane / 4 + 8 * h;
    const int py = bk.ty0 + m / TILE;
    const int px = bk.tx0 + m % TILE;
    if (py >= bk.H || px >= bk.W) continue;
    float* row = dst + ((static_cast<size_t>(bk.img) * bk.H + py) * bk.W + px) *
                           bk.O;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = bk.o_tile * BN + 8 * jn + 2 * (lane % 4) + e;
        if (o < bk.O) row[o] = acc[4 * jn + 2 * h + e];
      }
  }
}

// part (slices, N, H, W, O): slice blockIdx.z's sum over stages
// [z * slice_stages, min(stages, (z + 1) * slice_stages)) of the tile
// blockIdx.x (image, tile row, tile column) and output tile blockIdx.y.
template <int BN, int VX>
__global__ void __launch_bounds__(NT, 1)
ric_conv_fwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ wsplit,
                    const float* __restrict__ swf, float* __restrict__ part,
                    int H, int W, int C, int O, int tiles_x, int tiles_y,
                    int stages, int slice_stages, long long slice_elems) {
  extern __shared__ __align__(128) float smem[];
  const int per_image = tiles_x * tiles_y;
  const int tile = blockIdx.x % per_image;
  Block bk;
  bk.H = H;
  bk.W = W;
  bk.C = C;
  bk.O = O;
  bk.img = blockIdx.x / per_image;
  bk.ty0 = (tile / tiles_x) * TILE;
  bk.tx0 = (tile % tiles_x) * TILE;
  bk.o_tile = blockIdx.y;
  bk.s0 = blockIdx.z * slice_stages;
  bk.s1 = min(stages, bk.s0 + slice_stages);
  bk.stages = stages;
  if (threadIdx.x == 0) {
    const uint64_t* mbar =
        reinterpret_cast<const uint64_t*>(smem + Layout<BN>::MBAR_OFF);
    for (int r = 0; r < Layout<BN>::RING; ++r) mbar_init(smem_addr(mbar + r));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the role, warp-uniform as the compiler sees it (a shuffle), so that the
  // products are not issued on what it takes for a divergent path
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (role == 0)
    consume<BN>(bk, smem, part + blockIdx.z * slice_elems, threadIdx.x);
  else
    produce<BN, VX>(bk, smem, x, wsplit, swf, threadIdx.x - WG);
}

// wsplit (o_tiles, stages, 2, BN * CK): per output tile and stage (chunk
// s / 9, tap s % 9), the hi then the lo image of the K-major B tile,
// B[n, k] = wk[t, chunk * CK + k, o_tile * BN + n], zero past C and O.
__global__ void ric_conv_fwd_split_kernel(const float* __restrict__ wk,
                                          float* __restrict__ wsplit, int C,
                                          int O, int bn, int stages,
                                          long long elems) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= elems) return;
  const int b_floats = bn * CK;
  const int within = static_cast<int>(e % b_floats);
  const long long os = e / b_floats;
  const int s = static_cast<int>(os % stages);
  const int o_tile = static_cast<int>(os / stages);
  const int rem = within % GROUP;
  const int n = (within / GROUP) * 8 + (rem % CORE) / 4;
  const int k = (rem / CORE) * 4 + rem % 4;
  const int c = (s / 9) * CK + k;
  const int o = o_tile * bn + n;
  float v = 0.f;
  if (c < C && o < O) v = wk[(static_cast<size_t>(s % 9) * C + c) * O + o];
  float hi, lo;
  split_tf32(v, hi, lo);
  float* img = wsplit + os * 2 * b_floats;
  img[within] = hi;
  img[b_floats + within] = lo;
}

template <int BN, int VX>
int launch(const float* x, const float* wsplit, const float* swf,
           float* part, int n, int h, int w, int c, int o, int stages,
           int slice_stages, int slices, cudaStream_t stream) {
  constexpr size_t smem = Layout<BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ric_conv_fwd_kernel<BN, VX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + TILE - 1) / TILE;
  const int tiles_y = (h + TILE - 1) / TILE;
  const dim3 grid(n * tiles_x * tiles_y, (o + BN - 1) / BN, slices);
  ric_conv_fwd_kernel<BN, VX><<<grid, NT, smem, stream>>>(
      x, wsplit, swf, part, h, w, c, o, tiles_x, tiles_y, stages,
      slice_stages, static_cast<long long>(n) * h * w * o);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_vec(const float* x, bool vx4, const float* wsplit,
               const float* swf, float* part, int n, int h, int w, int c,
               int o, int stages, int slice_stages, int slices,
               cudaStream_t s) {
  if (vx4)
    return launch<BN, 4>(x, wsplit, swf, part, n, h, w, c, o, stages,
                         slice_stages, slices, s);
  return launch<BN, 1>(x, wsplit, swf, part, n, h, w, c, o, stages,
                       slice_stages, slices, s);
}

}  // namespace

// Plain C interface (the Python wrapper validates shapes, types, devices and
// contiguity, and allocates wsplit, the partial buffer and out). bn, ck,
// slice_stages and slices are the plan of kernels/ric_conv.py::fwd_plan;
// the launch is refused (cudaErrorInvalidValue) unless bn is 32, 64 or 128,
// ck is this kernel's chunk and the slices cover the 9 * ceil(c / ck)
// stages exactly. wsplit: (ceil(o / bn), stages, 2, bn * ck) floats; part:
// (slices, n, h, w, o) floats, unused (may be out) when slices == 1.
// Launches the split pre-pass, the product and, for slices > 1, the ordered
// sum of the slices; returns the first failing launch's cudaError_t, else 0.
extern "C" int ric_conv_fwd_launch(const float* x, const float* wk,
                                   const float* swf, float* wsplit,
                                   float* part, float* out, int n, int h,
                                   int w, int c, int o, int bn, int ck,
                                   int slice_stages, int slices,
                                   void* stream) {
  const int stages = 9 * ((c + CK - 1) / CK);
  if ((bn != 32 && bn != 64 && bn != 128) || ck != CK || n < 1 || h < 1 ||
      w < 1 || c < 1 || o < 1 || slice_stages < 1 || slices < 1 ||
      slices > 65535 || (slices - 1) * slice_stages >= stages ||
      slices * slice_stages < stages)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long split_elems =
      static_cast<long long>((o + bn - 1) / bn) * stages * bn * CK;
  ric_conv_fwd_split_kernel<<<static_cast<unsigned>((split_elems + 255) / 256),
                              256, 0, s>>>(wk, wsplit, c, o, bn, stages,
                                           split_elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dst = slices == 1 ? out : part;
  const bool vx4 = c % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  int e;
  if (bn == 32)
    e = launch_vec<32>(x, vx4, wsplit, swf, dst, n, h, w, c, o, stages,
                       slice_stages, slices, s);
  else if (bn == 64)
    e = launch_vec<64>(x, vx4, wsplit, swf, dst, n, h, w, c, o, stages,
                       slice_stages, slices, s);
  else
    e = launch_vec<128>(x, vx4, wsplit, swf, dst, n, h, w, c, o, stages,
                        slice_stages, slices, s);
  if (e != 0 || slices == 1) return e;
  return ric_conv_bwd_sum_slices_launch(
      part, out, static_cast<long long>(n) * h * w * o, slices, stream);
}

extern "C" const char* ric_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
