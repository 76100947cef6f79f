// Layer-, forest- and node-level ciphertext histograms for Hopper, sm_90a:
// one kernel body, three C entries.
//
// Replaces three TPU kernels of src/repro/kernels/histogram/histogram.py
// whose Pallas bodies are the same one-hot contraction:
//   * layer_hist_pallas / _layer_hist_kernel (pallas_call at line 142),
//     K1, through layer_hist_launch:
//
//       out[s, f, b, w] = sum over rows i with node_slot[i] == s and
//                         bins[i, f] == b of cts[i, w]
//
//     with node_slot (n_i,) and out (n_nodes, n_f, n_bins, W);
//   * forest_hist_pallas / _forest_hist_kernel (pallas_call at line 217),
//     K4, through forest_hist_launch: the same sums for each of k member
//     trees of a round-forest layer,
//
//       out[t, s, f, b, w] = sum over rows i with node_slot[i, t] == s
//                            and bins[i, f] == b of cts[i, w]
//
//     with node_slot (n_i, k) member-local slots and out (k, n_nodes, n_f,
//     n_bins, W).  K1 is the k = 1 case: the member index is one more grid
//     axis and node_slot is read with a column stride of k;
//   * hist_pallas / _hist_kernel (pallas_call at line 74), K5, through
//     node_hist_launch: one node's histogram,
//
//       out[f, b, w] = sum over rows i with bins[i, f] == b of cts[i, w]
//
//     with out (n_f, n_bins, W).  It is K1 with one node and a null slot
//     pointer, which the body reads as "every row is in node 0".
//
// bins (n_i, n_f) int32, node_slot (or null) and cts (n_i, W) int32
// limbs, all row-major; out int32 lazy (un-carried) sums, zero-filled by the caller.
// A row counts for (member t, feature f) only when 0 <= node_slot[i, t] <
// n_nodes and 0 <= bins[i, f] < n_bins: a negative slot or bin is the
// protocol's mask, and anything else out of range is skipped too, so no
// input can write outside `out`.  int32 addition is exact and independent
// of order (it wraps mod 2^32 exactly as the reference's int32 sums do),
// so the result is bit-identical to the plain version whatever order the
// atomics land in.
//
// What bounds it on an H100 SXM.  Bytes: each input read once and the
// output written once.  K1 at the training main path's largest call
// (65,536 rows, 14 host features, 32 bins, W = 131 limbs): 3.7 MB of
// bins, 0.26 MB of slots and 34.3 MB of limbs, 38.5 MB, 11.5 us at
// 3.35 TB/s.  K5 at the per-node engine's root (the same 65,536 rows,
// 14 features, 32 bins and W = 131, no slots): 3.67 MB of bins, 34.3 MB
// of limbs and 0.23 MB written, 38.2 MB, 11.4 us.  K4 at the forest4
// path's largest call (65,536 rows, 14 features, 32 bins, k = 4 members
// of 4 nodes, W = 67): 17.6 MB of limbs, 3.7 MB of bins, 1.0 MB of slots
// read and 1.9 MB written, about 24 MB, 7.2 us.  Operations: n_i * n_f *
// W int32 adds per member, 120 M for the K1 and K5 calls and 4 x 61 M
// for the K4 one, 1.8 us and 3.7 us at the published 67 T/s of 32-bit
// work outside the tensor cores.  So the bound is bytes.  This first version does not reach it:
//   * one block owns one (member, feature, node tile, limb tile, row
//     tile): a (nodes x n_bins x limbs) int32 histogram tile in shared
//     memory, kept within the 48 KB a launch gets without an opt-in (the
//     limb axis is tiled to fit, and the node axis too when one node's
//     bins alone do not leave a warp's width of limbs);
//   * thread t owns limb column t of the tile, for every cell, so the
//     shared-memory adds need no atomics and neighbouring threads touch
//     neighbouring banks; the threads of a warp read neighbouring limbs of
//     one row (coalesced);
//   * each chunk of 256 rows first stages its composite cell index
//     (slot * n_bins + bin, or -1) in shared memory, computed once per row
//     and read by every thread;
//   * at the end the block adds its non-zero cells into `out` with global
//     atomicAdd (int32: exact).
// Every (member, feature) pair's blocks read the limbs of their rows
// again, k * n_f reads in all, which L2 (50 MB, above the 34 MB and 18 MB
// batches) mostly serves.  A one-hot tensor-core GEMM (exact in fp32
// below 2^24 per tile) is the faster design and is left to a later
// version.
//
// C entries (loaded with ctypes, see kernels/build.py): each launches on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 256;                 // rows staged per step
constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSm = 8;             // grid target, in blocks per SM
// the static shared-memory window a block gets without an opt-in, less
// the staged cell indices
constexpr int kSmemBytes = 48 * 1024;
constexpr int kHistWords = kSmemBytes / 4 - kChunk;

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

__global__ void layer_hist_kernel(const int32_t* __restrict__ bins,
                                  const int32_t* __restrict__ slot,
                                  const int32_t* __restrict__ cts,
                                  int32_t* __restrict__ out, int64_t n_i,
                                  int n_f, int n_members, int n_nodes,
                                  int n_bins, int W, int node_tile,
                                  int n_ntiles, int w_tile, int n_wtiles,
                                  int64_t rows_per_block, int64_t n_rtiles) {
  extern __shared__ int32_t smem[];
  int32_t* s_cell = smem;                   // (kChunk,) cell or -1
  int32_t* s_hist = smem + kChunk;          // (nodes * n_bins, ww)

  int64_t b = blockIdx.x;
  const int64_t rt = b % n_rtiles;
  b /= n_rtiles;
  const int wt = static_cast<int>(b % n_wtiles);
  b /= n_wtiles;
  const int nt = static_cast<int>(b % n_ntiles);
  b /= n_ntiles;
  const int f = static_cast<int>(b % n_f);
  const int m = static_cast<int>(b / n_f);     // member tree

  const int n0 = nt * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int w0 = wt * w_tile;
  const int ww = min(w_tile, W - w0);
  const int words = nn * n_bins * ww;
  const int t = threadIdx.x;

  for (int k = t; k < words; k += blockDim.x) s_hist[k] = 0;

  const int64_t r_begin = rt * rows_per_block;
  const int64_t r_stop = r_begin + rows_per_block;
  const int64_t r_end = r_stop < n_i ? r_stop : n_i;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kChunk) {
    const int nr = r_end - r0 < kChunk ? static_cast<int>(r_end - r0)
                                       : kChunk;
    __syncthreads();                        // the last chunk is consumed
    for (int k = t; k < nr; k += blockDim.x) {
      const int64_t i = r0 + k;
      const int s = (slot ? slot[i * n_members + m] : 0) - n0;
      const int bn = bins[i * n_f + f];
      s_cell[k] = (s >= 0 && s < nn && bn >= 0 && bn < n_bins)
                      ? s * n_bins + bn : -1;
    }
    __syncthreads();
    if (t < ww) {
      const int32_t* src = cts + r0 * W + w0 + t;
#pragma unroll 8
      for (int k = 0; k < nr; ++k) {
        const int32_t v = src[static_cast<int64_t>(k) * W];
        const int c = s_cell[k];
        if (c >= 0) s_hist[c * ww + t] += v;
      }
    }
  }
  __syncthreads();

  for (int k = t; k < words; k += blockDim.x) {
    const int32_t v = s_hist[k];
    if (v != 0) {
      const int c = k / ww;
      const int w = k - c * ww;
      const int s = c / n_bins;
      const int bn = c - s * n_bins;
      const int64_t o =
          (((static_cast<int64_t>(m) * n_nodes + n0 + s) * n_f + f) *
               n_bins + bn) * W + w0 + w;
      atomicAdd(out + o, v);
    }
  }
}

// The launch every entry shares: k member trees (k = 1 for K1 and K5),
// node_slot null for K5 (every row in node 0 of n_nodes = 1).
int launch(const void* bins, const void* node_slot, const void* cts,
           void* out, long long n_i, int n_f, int k, int n_nodes, int n_bins,
           int W, void* stream) {
  if (n_i <= 0 || n_f <= 0 || k <= 0 || n_nodes <= 0 || n_bins <= 0 ||
      W <= 0 || n_bins > kHistWords) {
    return cudaErrorInvalidValue;
  }
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  // node tile: as many nodes as leave room for a warp's width of limbs
  int node_tile = kHistWords / (n_bins * 32);
  if (node_tile < 1) node_tile = 1;
  if (node_tile > n_nodes) node_tile = n_nodes;
  const int n_ntiles = static_cast<int>(cdiv(n_nodes, node_tile));
  node_tile = static_cast<int>(cdiv(n_nodes, n_ntiles));
  // limb tile: what the shared histogram holds, in even tiles
  int w_max = kHistWords / (node_tile * n_bins);
  if (w_max > kMaxThreads) w_max = kMaxThreads;
  const int n_wtiles = static_cast<int>(cdiv(W, w_max));
  const int w_tile = static_cast<int>(cdiv(W, n_wtiles));
  const int threads = static_cast<int>(cdiv(w_tile, 32) * 32);
  // row tile: about kBlocksPerSm blocks per SM over the whole grid
  const int64_t combos =
      static_cast<int64_t>(k) * n_f * n_ntiles * n_wtiles;
  const int64_t target = static_cast<int64_t>(n_sm) * kBlocksPerSm;
  int64_t rows_per_block = cdiv(cdiv(n_i * combos, target), kChunk) * kChunk;
  if (rows_per_block < kChunk) rows_per_block = kChunk;
  const int64_t n_rtiles = cdiv(n_i, rows_per_block);
  const int64_t blocks = combos * n_rtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      (static_cast<size_t>(kChunk) + static_cast<size_t>(node_tile) * n_bins *
                                         w_tile) * sizeof(int32_t);
  if (smem > static_cast<size_t>(kSmemBytes)) return cudaErrorInvalidValue;

  layer_hist_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(node_slot),
      static_cast<const int32_t*>(cts), static_cast<int32_t*>(out), n_i, n_f,
      k, n_nodes, n_bins, W, node_tile, n_ntiles, w_tile, n_wtiles,
      rows_per_block, n_rtiles);
  return cudaGetLastError();
}

}  // namespace

// K1: node_slot (n_i,) -> out (n_nodes, n_f, n_bins, W).
extern "C" int layer_hist_launch(const void* bins, const void* node_slot,
                                 const void* cts, void* out, long long n_i,
                                 int n_f, int n_nodes, int n_bins, int W,
                                 void* stream) {
  return launch(bins, node_slot, cts, out, n_i, n_f, 1, n_nodes, n_bins, W,
                stream);
}

// K4: node_slot (n_i, k) -> out (k, n_nodes, n_f, n_bins, W).
extern "C" int forest_hist_launch(const void* bins, const void* node_slot,
                                  const void* cts, void* out, long long n_i,
                                  int n_f, int k, int n_nodes, int n_bins,
                                  int W, void* stream) {
  return launch(bins, node_slot, cts, out, n_i, n_f, k, n_nodes, n_bins, W,
                stream);
}

// K5: no slots, every row in the one node -> out (n_f, n_bins, W).
extern "C" int node_hist_launch(const void* bins, const void* cts, void* out,
                                long long n_i, int n_f, int n_bins, int W,
                                void* stream) {
  return launch(bins, nullptr, cts, out, n_i, n_f, 1, 1, n_bins, W, stream);
}
