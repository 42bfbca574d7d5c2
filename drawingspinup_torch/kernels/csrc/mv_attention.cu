// Attention core of the stage-2a MV UNet: a flash-attention forward on bf16
// q, k and v, for Hopper (sm_90a).
//
// out[b, i, h·D:(h+1)·D] = softmax_j(q_i · k_j / sqrt(D)) · v_j over the
// Sk keys of row b, for every head h; q, k, v and out lie in the (B, S,
// heads·D) layout of the UNet's projections, each with its own batch and
// row stride (in elements), so the split path's keys, every second half of
// a gathered (rows, S, 2C) tensor, are read where they lie.
//
// It replaces no Pallas kernel: the JAX package computes the core with
// jax.nn.dot_product_attention on q, k and v upcast to f32
// (drawingspinup_tpu/models/attention_mv.py::_attention), because bf16
// attention took a slow path on TPU v5e. The arithmetic is that of
// half-precision flash attention and of the published fp16 pipeline: the
// products S = Q·Kᵀ and O = P·V on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulators), the online softmax in f32 on exp2 with
// 1/sqrt(D)·log2(e) folded into one scale, P rounded to bf16 for P·V (the
// only rounding beyond the inputs' and the output's), O normalised in f32
// and stored as bf16.
//
// What bounds it on the card: at D = 40, where 88 % of a uid's work is, a
// uid's cores are 55 TFLOP of bf16 products (0.056 s at the dense peak) and
// ~3.2e11 exponentials (~0.08 s at 16 a clock per SM), with f32 max, scale
// and sum work of the same order: the softmax, not the tensor cores and not
// the bytes (one views core's K and V, 15.7 MB, stay in L2). The design:
// - a warp owns 16·MT whole query rows, so a row's max and sum need only
//   the shuffles of its four lanes, and P goes from the S accumulators to
//   the A operand of P·V in registers (the accumulator layout of two n8
//   tiles is the A layout of one k16 step);
// - Q's fragments are loaded once and stay in registers for the whole key
//   loop; at MT = 2 (d = 40) each K and V fragment read from shared memory
//   feeds two products, which keeps shared memory below the tensor cores'
//   rate;
// - K and V tiles of BN keys are double-buffered with cp.async, so the
//   next tile's loads overlap this tile's products and softmax, and two or
//   more blocks share an SM, so the warp schedulers overlap one warp's
//   exponentials with another's products;
// - D = 40 (and 8) is padded to the product depth of 48 (16) with zeros in
//   shared memory only (written once; the loads never touch those
//   columns); P·V runs over the true columns in n8 tiles;
// - ragged lengths: query rows past Sq load zeros and store nothing; keys
//   past Sk load zeros (so a zero weight never meets an undefined value)
//   and score -inf in the last tile.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  int sq, sk;
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, or 16 zero bytes where !ok (src not read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a (16×16, row) · b (16×8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 → bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// K and V rows [n0, n0 + BN) of one head into a buffer (BN rows of PITCH),
// zeros past Sk
template <int D, int BN, int PITCH>
__device__ __forceinline__ void load_kv(const uint16_t* kg, const uint16_t* vg,
                                        const Params& p, int n0, uint16_t* sk,
                                        uint16_t* sv, int tid) {
  constexpr int CH = D / 8;
  for (int c = tid; c < BN * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = n0 + r < p.sk;
    const long long key = ok ? n0 + r : 0;
    cp_async_16(smem_addr(sk + r * PITCH + col), kg + key * p.k_rs + col, ok);
    cp_async_16(smem_addr(sv + r * PITCH + col), vg + key * p.v_rs + col, ok);
  }
}

// A block: one (row b, head h) and BM = 64·MT query rows, 16·MT a warp;
// keys in tiles of BN; at least MINB blocks an SM.
template <int D, int MT, int BN, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    mv_attention_kernel(const Params p) {
  constexpr int DK = (D + 15) / 16 * 16;  // S's depth: D padded with zeros
  constexpr int PITCH = DK + 8;  // a row's elements in shared memory: the 8
                                 // rows of an ldmatrix lie on distinct banks
  constexpr int BM = kWarps * 16 * MT;
  constexpr int CH = D / 8;  // 16-byte chunks of one head's row
  constexpr int NT = BN / 8;  // n8 tiles of S
  constexpr int OT = D / 8;   // n8 tiles of O
  static_assert(D % 8 == 0 && BN % 16 == 0, "tile shapes");

  __shared__ __align__(16) uint16_t sq[BM * PITCH];
  __shared__ __align__(16) uint16_t sk[2 * BN * PITCH];
  __shared__ __align__(16) uint16_t sv[2 * BN * PITCH];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lrow = lane & 7, lmat = lane >> 3;  // ldmatrix address roles
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const uint16_t* qg = p.q + b * p.q_bs + h * D;
  const uint16_t* kg = p.k + b * p.k_bs + h * D;
  const uint16_t* vg = p.v + b * p.v_bs + h * D;
  uint16_t* og = p.o + b * p.o_bs + h * D;

  if (DK > D) {
    for (int r = tid; r < BM + 2 * BN; r += kThreads) {
      uint16_t* row = r < BM ? sq + r * PITCH : sk + (r - BM) * PITCH;
      for (int c = D; c < DK; c += 8)
        *reinterpret_cast<uint4*>(row + c) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int c = tid; c < BM * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = m0 + r < p.sq;
    const long long row = ok ? m0 + r : 0;
    cp_async_16(smem_addr(sq + r * PITCH + col), qg + row * p.q_rs + col,
                ok);
  }
  load_kv<D, BN, PITCH>(kg, vg, p, 0, sk, sv, tid);
  cp_async_commit();

  const int tiles = (p.sk + BN - 1) / BN;
  const int wrow = warp * 16 * MT;  // the warp's first row in the block
  uint32_t qf[MT][DK / 16][4];
  float o[MT][OT][4];
  float mx[MT][2], sum[MT][2];  // a row's running max (log2 units), sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[mt][i] = -INFINITY;
      sum[mt][i] = 0.f;
    }
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][ot][e] = 0.f;
  }

  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles)
      load_kv<D, BN, PITCH>(kg, vg, p, (j + 1) * BN,
                            sk + (buf ^ 1) * BN * PITCH,
                            sv + (buf ^ 1) * BN * PITCH, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and, at j = 0, Q) has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldsm_x4(smem_addr(sq +
                            (wrow + mt * 16 + (lmat & 1) * 8 + lrow) * PITCH +
                            kk * 16 + (lmat >> 1) * 8),
                  qf[mt][kk]);
    }
    const uint16_t* kt = sk + buf * BN * PITCH;
    const uint16_t* vt = sv + buf * BN * PITCH;

    // S = Q·Kᵀ: an x4 ldmatrix gives the B fragments of two n8 tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(smem_addr(kt + (np * 16 + (lmat >> 1) * 8 + lrow) * PITCH +
                          kk * 16 + (lmat & 1) * 8),
                bk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
          mma(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
        }
      }
    }
    if ((j + 1) * BN > p.sk) {  // the last tile: keys past Sk score -inf
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * BN + nt * 8 + (lane & 3) * 2 + (e & 1) >= p.sk)
              s[mt][nt][e] = -INFINITY;
    }

    // online softmax; a thread holds rows lane/4 (e = 0, 1) and lane/4 + 8
    // (e = 2, 3) of each m16 tile, a row's other columns on its quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          m = fmaxf(m, fmaxf(s[mt][nt][2 * hr], s[mt][nt][2 * hr + 1]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        // every tile holds a key below Sk, so m is finite
        const float mnew = fmaxf(mx[mt][hr], m * p.scale_log2);
        const float alpha = ex2(mx[mt][hr] - mnew);
        mx[mt][hr] = mnew;
        float add = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float pe = ex2(fmaf(s[mt][nt][e], p.scale_log2, -mnew));
            s[mt][nt][e] = pe;
            add += pe;
          }
        sum[mt][hr] = sum[mt][hr] * alpha + add;
#pragma unroll
        for (int ot = 0; ot < OT; ++ot) {
          o[mt][ot][2 * hr] *= alpha;
          o[mt][ot][2 * hr + 1] *= alpha;
        }
      }
    }

    // O += P·V: P (bf16) from two S tiles is one k16 A fragment; a .trans
    // ldmatrix of V (keys × D) gives the B fragments of two n8 tiles of O
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
      const uint16_t* vrow = vt + (kk * 16 + (lmat & 1) * 8 + lrow) * PITCH;
#pragma unroll
      for (int op = 0; op < OT / 2; ++op) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_addr(vrow + (2 * op + (lmat >> 1)) * 8), bv);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * op], a[mt], bv[0], bv[1]);
          mma(o[mt][2 * op + 1], a[mt], bv[2], bv[3]);
        }
      }
      if (OT % 2) {
        uint32_t bv[2];
        ldsm_x2_trans(smem_addr(vrow + (OT - 1) * 8), bv);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(o[mt][OT - 1], a[mt], bv[0], bv[1]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before its refill
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = sum[mt][hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = m0 + wrow + mt * 16 + hr * 8 + (lane >> 2);
      if (row < p.sq) {
        uint16_t* dst = og + row * p.o_rs + (lane & 3) * 2;
#pragma unroll
        for (int ot = 0; ot < OT; ++ot)
          *reinterpret_cast<uint32_t*>(dst + ot * 8) = pack_bf16(
              o[mt][ot][2 * hr] * inv, o[mt][ot][2 * hr + 1] * inv);
      }
    }
  }
}

template <int D, int MT, int BN, int MINB>
int launch(const Params& p, int b, int heads, cudaStream_t stream) {
  constexpr int BM = kWarps * 16 * MT;
  const dim3 grid((p.sq + BM - 1) / BM, heads, b);
  mv_attention_kernel<D, MT, BN, MINB><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one attention core on ``stream``: q (b, sq, heads·d), k and v
// (b, sk, heads·d), out (b, sq, heads·d), bf16, with the given batch and
// row strides in elements (multiples of 8, the unit stride last; the
// wrapper checks them and 16-byte aligned pointers). The tiles per head
// dim: (MT, BN) = (2, 64) at d 8, 16 and 40, (1, 32) at 80, (1, 16) at 160
// (at 40, 80 and 160 the fastest of the variants timed at the cell's
// shapes); any other d is refused. Returns the cudaError_t code.
extern "C" int mv_attention_launch(const void* q, const void* k,
                                   const void* v, void* out, long long q_bs,
                                   long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs,
                                   long long o_rs, int b, int sq, int sk,
                                   int heads, int d, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint16_t*>(q),
           static_cast<const uint16_t*>(k),
           static_cast<const uint16_t*>(v),
           static_cast<uint16_t*>(out),
           q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, sq, sk,
           static_cast<float>(1.4426950408889634 / std::sqrt(double(d)))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:  // the narrow UNets of the tests, the CLI's --tiny and dry run
      return launch<8, 2, 64, 2>(p, b, heads, s);
    case 16:
      return launch<16, 2, 64, 2>(p, b, heads, s);
    case 40:
      return launch<40, 2, 64, 2>(p, b, heads, s);
    case 80:
      return launch<80, 1, 32, 4>(p, b, heads, s);
    case 160:
      return launch<160, 1, 16, 2>(p, b, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
