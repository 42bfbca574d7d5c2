// Row gather out[k] = tab[idx[k]] of a (T, C) table with fixed-width rows,
// for sm_90a.
//
// Replaces the Pallas TPU kernels of scripts/bench_pallas_gather.py,
// pallas_gather(kind="rowdma") (rowdma_kernel: one DMA per row from HBM,
// NSLOTS in flight) and pallas_gather(kind="vmemds") (vmemds_kernel: the
// table resident in VMEM, one dynamic slice per row), both for a (T, 16)
// bf16 table and int32 indices. The device function gather_row
// (hashgrid_common.cuh) is the one the encode kernel fetches its corner
// rows with. As XLA's gather, an index outside [0, T) is clamped.
//
// What bounds it on the card: device-memory latency and row granularity.
// Each thread reads one 4-64 byte row at a random address (a 32-byte row is
// one sector) and writes it back contiguously; the achievable rate is set
// by how many sectors are in flight, so threads are many and each starts
// its row's 16-byte loads together. A TPU has no such gather path (a DMA or
// a scalar-indexed slice per row); on Hopper it is a plain load.

#include "hashgrid_common.cuh"

namespace {

using namespace dsu_hashgrid;

constexpr int kThreads = 256;

template <int WORDS>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint32_t* __restrict__ tab, long long T,
                  const int* __restrict__ idx, long long K,
                  uint32_t* __restrict__ out) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= K) return;
  long long row = __ldg(idx + k);
  row = row < 0 ? 0 : (row >= T ? T - 1 : row);
  uint32_t w[WORDS];
  gather_row<WORDS>(tab, row, w);
  store_row<WORDS>(out, k, w);
}

template <int WORDS>
int launch(const void* tab, long long T, const int* idx, long long K,
           void* out, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((K + kThreads - 1) / kThreads);
  row_gather_kernel<WORDS><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(tab), T, idx, K,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface: tab (T, row_bytes) contiguous, idx (K,) int32, out
// (K, row_bytes) allocated by the wrapper. Returns the cudaError_t of the
// launch: 0 on success.
extern "C" int row_gather_launch(const void* tab, long long T, int row_bytes,
                                 const int* idx, long long K, void* out,
                                 void* stream) {
  if (K < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_bytes) {
    case 4: return launch<1>(tab, T, idx, K, out, s);
    case 8: return launch<2>(tab, T, idx, K, out, s);
    case 16: return launch<4>(tab, T, idx, K, out, s);
    case 32: return launch<8>(tab, T, idx, K, out, s);
    case 48: return launch<12>(tab, T, idx, K, out, s);
    case 64: return launch<16>(tab, T, idx, K, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
