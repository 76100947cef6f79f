// Quantile binning (bucketize) for Hopper, sm_90a.
//
// Replaces the TPU kernel bucketize_pallas / _bucketize_kernel in
// src/repro/kernels/binning/binning.py:
//
//     bin(i, f) = #{t : values[i, f] >= thresholds[f, t]}
//
// values (n_i, n_f) float32 row-major, thresholds (n_f, n_t) float32 with
// each row ascending and +inf padded, out (n_i, n_f) int32.
//
// What bounds it: memory.  Each element is one 4-byte read and one 4-byte
// write, so the least time on an H100 SXM is 8 * n_i * n_f bytes over
// 3.35 TB/s; the n_t compares per element are far below the card's rate.
// Design for that:
//   * one thread per (i, f) over the flat row-major index, so the 32
//     threads of a warp read 32 neighbouring floats and write 32
//     neighbouring ints (fully coalesced, no padding of ragged shapes);
//   * the whole threshold table is staged once per block in shared memory
//     (n_f * n_t floats: 2 KB at 16 x 31; a table over 48 KB is refused),
//     and the grid is capped at a few blocks per SM with a grid-stride
//     loop, so the table is fetched once per block, not once per element.
//     Neighbouring threads read rows n_t floats apart; n_t = 31 is odd,
//     so they fall in distinct banks;
//   * the count is a linear scan of `v >= t`, the same comparison as the
//     plain version (kernels/binning/ref.py): NaN counts 0, +inf counts
//     every threshold including the +inf padding, -0.0 equals 0.0, and
//     subnormal values and thresholds compare as zero, as XLA compares
//     them for the JAX reference (flushed explicitly, so the result does
//     not hang on the -ftz flag).
//
// C entry (loaded with ctypes, see kernels/build.py): launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// the static shared-memory window a block gets without an opt-in; the
// serving path's table is 2 KB
constexpr size_t kMaxTableBytes = 48 * 1024;

// subnormal -> 0; NaN and +-inf pass (the compare is false for NaN)
__device__ __forceinline__ float flush_denormal(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

__global__ void bucketize_kernel(const float* __restrict__ values,
                                 const float* __restrict__ thresholds,
                                 int32_t* __restrict__ out, int64_t n,
                                 int n_f, int n_t) {
  extern __shared__ float s_thr[];
  const int table = n_f * n_t;
  for (int k = threadIdx.x; k < table; k += blockDim.x) {
    s_thr[k] = flush_denormal(thresholds[k]);
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the feature of element e, stepped by the grid stride in 32-bit
  // arithmetic (one 64-bit division per thread, not one per element)
  int f = static_cast<int>(e % n_f);
  const int df = static_cast<int>(stride % n_f);
  for (; e < n; e += stride) {
    const float v = flush_denormal(values[e]);
    const float* t = s_thr + f * n_t;
    int32_t c = 0;
    for (int j = 0; j < n_t; ++j) {
      c += (v >= t[j]) ? 1 : 0;
    }
    out[e] = c;
    f += df;
    if (f >= n_f) f -= n_f;
  }
}

}  // namespace

extern "C" int bucketize_launch(const void* values, const void* thresholds,
                                void* out, long long n_i, int n_f, int n_t,
                                void* stream) {
  const int64_t n = static_cast<int64_t>(n_i) * n_f;
  const size_t smem = static_cast<size_t>(n_f) * n_t * sizeof(float);
  if (n <= 0 || n_f <= 0 || n_t < 0 || smem > kMaxTableBytes) {
    return cudaErrorInvalidValue;
  }
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(n_sm) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  bucketize_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(thresholds),
      static_cast<int32_t*>(out), n, n_f, n_t);
  return cudaGetLastError();
}
