// RIC conv backward, its two products, f32-accurate (3xTF32) on the tensor
// cores, for sm_90a.
//
// Replaces the two dot_generals of the Pallas TPU kernel
// drawingspinup_tpu/kernels/ric_conv.py::_bwd_kernel (driven by _bwd_call),
// once ric_conv_bwd.cu's dz kernel has written the sampled cotangent to an
// (N*H*W, 9, O) scratch. With P = N*H*W pixels and J = 9*O (tap, output)
// columns both are plain GEMMs, C[m, n] = sum_k A[m, k] * B[k, n]:
//
//   dx  (P x C) = dz (P x J) . wk^T (J x C)    A K-major (dz rows), B = the
//                                              (9, O, C) transpose of wk
//   dwk (C x J) = x^T (C x P) . dz (P x J)     A M-major (x rows are pixels)
//
// What bounds it on the card: arithmetic. Per training step (40 x 32^2
// patches, 21 launches) the two products are 92.8 GFLOP; in f32 outside the
// tensor cores (67 TFLOP/s) that is 1.39 ms, in 3xTF32 (three TF32 products
// per f32 product, 495 TFLOP/s) 0.56 ms; the bytes (x, g, wk, swf read, dx
// and dwk written: 0.30 GB) are 0.09 ms at 3.35 TB/s. The earlier SIMT
// kernels reached ~9 TFLOP/s.
// What the design does about it:
//
//   * mma.sync.m16n8k8 with .tf32 operands. Each f32 operand v is split into
//     hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi); per k-step a
//     fresh f32 register accumulator takes lo*hi, then hi*lo, then hi*hi,
//     and is then added to the running sum by an f32 add. hi*hi alone
//     (plain TF32) would keep ~3 decimal digits; the split keeps the f32
//     products' accuracy. The fresh accumulator keeps the sum's: the tensor
//     cores' own f32 accumulation truncates, and over the 512 k-steps of a
//     4096-pixel slice that drifted to ~3e-5 relative L2 from float64; one
//     rounded add per k-step holds it near 1e-6, as an f32 FMA loop. No
//     plain-TF32 path exists.
//   * A 64 x 64 block tile (4 warps of 32 x 32), 32-deep stages, staged with
//     cp.async into two shared-memory buffers (36 KB): the next stage loads
//     while the tensor cores work on this one. 16-byte copies where a row
//     is 16-byte aligned (leading dimension % 4 == 0), 4-byte copies
//     otherwise (C = 6, 166; O = 7). Ragged edges and the end of K are
//     zero-filled by the copy itself (cp.async's source size).
//   * Shared layouts keep every fragment read on 32 distinct banks: A from a
//     K-major source is staged [m][k] with a row stride of 36 floats, A from
//     an M-major source (x, whose rows are pixels) is staged [k][m] as it
//     lies, stride 72 (no transpose through registers), B [k][n], stride 72.
//   * Pixels are flattened across the batch, so an 8^2 image fills tiles as
//     a 32^2 one does. Where the output tiles alone give too few blocks for
//     the 132 SMs, K is cut into fixed slices (blockIdx.z), each written to
//     its own partial buffer and summed in slice order by a second pass
//     (ric_conv_bwd.cu): no float atomics, so two launches give the same
//     bits. The split is planned in Python (kernels/ric_conv.py::gemm_plan)
//     from the shape alone; the launcher checks the tile sizes it assumed.
//
// wgmma, TMA and a deeper ring of stages are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 64;                      // block tile rows
constexpr int BN = 64;                      // block tile columns
constexpr int BK = 32;                      // stage depth
constexpr int WM = 32;                      // warp tile rows
constexpr int WN = 32;                      // warp tile columns
constexpr int WARPS_M = BM / WM;
constexpr int NT = 32 * WARPS_M * (BN / WN);  // 128 threads
constexpr int MI = WM / 16;                 // m16 fragments per warp
constexpr int NI = WN / 8;                  // n8 fragments per warp
constexpr int AK_STRIDE = BK + 4;           // A staged [m][k]
constexpr int AM_STRIDE = BM + 8;           // A staged [k][m]
constexpr int B_STRIDE = BN + 8;            // B staged [k][n]
constexpr int A_FLOATS =
    BM * AK_STRIDE > BK * AM_STRIDE ? BM * AK_STRIDE : BK * AM_STRIDE;
constexpr int STAGE_FLOATS = A_FLOATS + BK * B_STRIDE;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Copy V floats (16 bytes for V = 4, 4 for V = 1) into shared memory; the
// first `valid` are read from src, the rest are zero-filled. src must be a
// valid address even when valid == 0.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// v = hi + lo + O(2^-22 |v|), hi and lo TF32 values (low 13 bits zero).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [k0, k0 + BK) of A's (m0 .. m0+BM) x K block and of B's K x
// (n0 .. n0+BN) block, zero past M, N and k1.
template <bool A_KMAJOR, int VA, int VB>
__device__ __forceinline__ void load_stage(float* as, float* bs,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int M, int N, int K, int m0,
                                           int n0, int k0, int k1, int tid) {
  static_assert((BM * BK) % (NT * VA) == 0 && (BK * BN) % (NT * VB) == 0,
                "every thread stages the same number of copies");
  if constexpr (A_KMAJOR) {
    constexpr int PER_ROW = BK / VA;
#pragma unroll
    for (int r = 0; r < BM * PER_ROW / NT; ++r) {
      const int e = tid + r * NT;
      const int m = e / PER_ROW;
      const int kk = (e % PER_ROW) * VA;
      const int gm = m0 + m;
      const int gk = k0 + kk;
      const int valid = gm < M ? clampi(k1 - gk, 0, VA) : 0;
      cp_async<VA>(as + m * AK_STRIDE + kk,
                   valid ? a + static_cast<size_t>(gm) * K + gk : a, valid);
    }
  } else {
    constexpr int PER_ROW = BM / VA;
#pragma unroll
    for (int r = 0; r < BK * PER_ROW / NT; ++r) {
      const int e = tid + r * NT;
      const int kk = e / PER_ROW;
      const int m = (e % PER_ROW) * VA;
      const int gk = k0 + kk;
      const int gm = m0 + m;
      const int valid = gk < k1 ? clampi(M - gm, 0, VA) : 0;
      cp_async<VA>(as + kk * AM_STRIDE + m,
                   valid ? a + static_cast<size_t>(gk) * M + gm : a, valid);
    }
  }
  constexpr int PER_ROW_B = BN / VB;
#pragma unroll
  for (int r = 0; r < BK * PER_ROW_B / NT; ++r) {
    const int e = tid + r * NT;
    const int kk = e / PER_ROW_B;
    const int n = (e % PER_ROW_B) * VB;
    const int gk = k0 + kk;
    const int gn = n0 + n;
    const int valid = gk < k1 ? clampi(N - gn, 0, VB) : 0;
    cp_async<VB>(bs + kk * B_STRIDE + n,
                 valid ? b + static_cast<size_t>(gk) * N + gn : b, valid);
  }
}

// part[s] = A[:, K_s] . B[K_s, :] for the slice K_s = [s * slice_k,
// min(K, (s + 1) * slice_k)), s = blockIdx.z; part is (slices, M, N).
// A is a[m * K + k] (K-major) or a[k * M + m]; B is b[k * N + n].
template <bool A_KMAJOR, int VA, int VB>
__global__ void __launch_bounds__(NT)
ric_conv_bwd_gemm_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ part, int M, int N, int K,
                         int slice_k) {
  __shared__ __align__(16) float smem[2 * STAGE_FLOATS];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;                   // fragment row group
  const int t = lane % 4;                   // thread in group
  const int wm = (warp % WARPS_M) * WM;
  const int wn = (warp / WARPS_M) * WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int s = blockIdx.z;
  const int k_begin = s * slice_k;
  const int k_end = min(K, k_begin + slice_k);
  const int stages = (k_end - k_begin + BK - 1) / BK;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_stage<A_KMAJOR, VA, VB>(smem, smem + A_FLOATS, a, b, M, N, K, m0, n0,
                               k_begin, k_end, tid);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      float* nxt = smem + ((st + 1) & 1) * STAGE_FLOATS;
      load_stage<A_KMAJOR, VA, VB>(nxt, nxt + A_FLOATS, a, b, M, N, K, m0,
                                   n0, k_begin + (st + 1) * BK, k_end, tid);
    }
    cp_async_commit();                      // an empty group on the last stage
    cp_async_wait_one();                    // this stage's copies have landed
    __syncthreads();
    const float* as = smem + (st & 1) * STAGE_FLOATS;
    const float* bs = as + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
          const int m = wm + i * 16 + g + (r & 1) * 8;
          const int k = kk + t + (r >> 1) * 4;
          const float v = A_KMAJOR ? as[m * AK_STRIDE + k]
                                   : as[k * AM_STRIDE + m];
          split_tf32(v, ah[i][r], al[i][r]);
        }
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // b0 (k = t, n = g), b1 (k = t+4, n = g)
          const float v = bs[(kk + t + r * 4) * B_STRIDE + wn + j * 8 + g];
          split_tf32(v, bh[j][r], bl[j][r]);
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(c, al[i], bh[j]);
          mma_tf32(c, ah[i], bl[j]);
          mma_tf32(c, ah[i], bh[j]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += c[r];
        }
    }
    __syncthreads();                        // this buffer is refilled next
  }

  float* out = part + static_cast<size_t>(s) * M * N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
        const int m = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (r & 1);
        if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j][r];
      }
}

template <bool A_KMAJOR, int VA, int VB>
int launch(const float* a, const float* b, float* part, int m, int n, int k,
           int slice_k, int slices, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, slices);
  ric_conv_bwd_gemm_kernel<A_KMAJOR, VA, VB>
      <<<grid, NT, 0, stream>>>(a, b, part, m, n, k, slice_k);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies of an operand whose rows are 16-byte aligned, else 4-byte.
template <bool A_KMAJOR>
int launch_vec(const float* a, bool va4, const float* b, bool vb4,
               float* part, int m, int n, int k, int slice_k, int slices,
               cudaStream_t s) {
  if (va4 && vb4)
    return launch<A_KMAJOR, 4, 4>(a, b, part, m, n, k, slice_k, slices, s);
  if (va4)
    return launch<A_KMAJOR, 4, 1>(a, b, part, m, n, k, slice_k, slices, s);
  if (vb4)
    return launch<A_KMAJOR, 1, 4>(a, b, part, m, n, k, slice_k, slices, s);
  return launch<A_KMAJOR, 1, 1>(a, b, part, m, n, k, slice_k, slices, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C interface. part: (slices, m, n) floats (the output itself when
// slices == 1); a_kmajor: A is (m, k) row-major, else (k, m) row-major; b is
// (k, n) row-major. bm, bn, bk are the tile sizes the caller planned with;
// the launch is refused (cudaErrorInvalidValue) unless they are this
// kernel's and the slices cover k exactly. Returns the cudaError_t of the
// launch: 0 on success.
extern "C" int ric_conv_bwd_gemm_launch(const float* a, int a_kmajor,
                                        const float* b, float* part, int m,
                                        int n, int k, int slice_k,
                                        int slices, int bm, int bn, int bk,
                                        void* stream) {
  if (bm != BM || bn != BN || bk != BK || m < 1 || n < 1 || k < 1 ||
      slice_k < 1 || slice_k % BK != 0 || slices < 1 || slices > 65535 ||
      static_cast<long long>(slices - 1) * slice_k >= k ||
      static_cast<long long>(slices) * slice_k < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lda = a_kmajor ? k : m;
  const bool va4 = lda % 4 == 0 && aligned16(a);
  const bool vb4 = n % 4 == 0 && aligned16(b);
  if (a_kmajor)
    return launch_vec<true>(a, va4, b, vb4, part, m, n, k, slice_k, slices, s);
  return launch_vec<false>(a, va4, b, vb4, part, m, n, k, slice_k, slices, s);
}
