// Fixed-constant big-integer multiply for Hopper, sm_90a.
//
// Replaces the TPU kernel mul_fixed_pallas / _mul_fixed_kernel in
// src/repro/kernels/modmul/modmul.py (pallas_call at line 67):
//
//     out[r, :] = canonical limbs of (x[r, :] @ T) mod 2^(8 * Lo)
//
// x (N, Lx) int32 canonical limbs (0..255) of N big integers, T (Lx, Lo)
// int32 the Toeplitz limb matrix of one fixed big integer b (entries
// 0..255, T[i, i + j] = b[j]), both row-major; out (N, Lo) int32 canonical
// limbs of x * b mod 2^(8 * Lo), written whole.  This is every product with
// a fixed big integer on the affine cipher's path: encryption (b = a),
// decryption (b = a^-1 mod n) and the two products of each Barrett
// reduction (mu and n).
//
// Integer arithmetic only.  A column sum is Lx products below 2^16, and the
// carry into it is below the column bound over 255, so the int32 sums are
// exact while Lx * 255 * 256 < 2^31 (the wrapper refuses wider x).  The
// carry is one sequential pass per row with arithmetic >> 8 and & 255, the
// signed-digit carry of the port's carry_fix, and the carry out of the top
// limb is dropped: a single ripple reaches the canonical form of
// sum_j v_j 256^j mod 256^Lo, the value the TPU kernel's iterated ripple and
// carry_fix reach, so the result is bit-identical to the plain version.
//
// What bounds it on an H100 SXM, at the training main path's largest call
// (encryption at 1024-bit keys: N = 65,536 rows, Lx = 128, Lo = 256).
// Bytes: x read once (33.6 MB), out written once (67.1 MB), T once (0.13
// MB): 100.8 MB, 30 us at 3.35 TB/s.  Operations: N * Lx * Lo = 2.1 G int32
// multiply-adds, half of them on the Toeplitz zeros; 32-bit integer
// multiply-add issues at half the fp32 rate on CUDA cores (64 a clock per
// SM), so this design needs about 0.14 ms for them, well above the byte
// bound.  The first design, simple and right:
//   * one block owns kRows rows of x, staged in shared memory (broadcast
//     reads: every thread reads the same limb);
//   * each thread owns kCols output columns of those rows and keeps
//     kRows x kCols int32 sums in registers, reading its columns of T
//     (coalesced across the warp, served from L1/L2: T is at most a few
//     hundred KB and every block reads all of it);
//   * the sums go to shared memory, one thread per row ripples the carry
//     through its Lo limbs in place (the row stride is odd, so the rows'
//     threads hit different banks), and the block writes its rows out
//     coalesced.
// Skipping the Toeplitz zeros, the tensor cores (bf16 limbs are exact and
// fp32 sums exact below 2^24) and fusing the whole Barrett modular multiply
// into one kernel are later versions.
//
// C entry (loaded with ctypes, see kernels/build.py): launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCols = 2;                    // output columns per thread
constexpr int kMaxThreads = 1024;
// the shared-memory window a block gets without an opt-in
constexpr int kSmemBytes = 48 * 1024;

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// row stride of the staged sums: odd, so the carry threads' rows fall on
// different shared-memory banks
__host__ __device__ __forceinline__ int sum_stride(int Lo) {
  return Lo | 1;
}

template <int kRows>
__global__ void mul_fixed_kernel(const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ T,
                                 int32_t* __restrict__ out, int64_t n, int Lx,
                                 int Lo) {
  extern __shared__ int32_t smem[];
  const int Ls = sum_stride(Lo);
  int32_t* xs = smem;                       // (kRows, Lx) staged rows
  int32_t* ys = smem + kRows * Lx;          // (kRows, Ls) sums, then limbs

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nr = n - r0 < kRows ? static_cast<int>(n - r0) : kRows;
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  // the block's rows are contiguous in x; rows past the end stage zeros
  const int32_t* src = x + r0 * Lx;
  for (int k = t; k < kRows * Lx; k += nt) {
    xs[k] = k < nr * Lx ? src[k] : 0;
  }
  __syncthreads();

  for (int j0 = 0; j0 < Lo; j0 += kCols * nt) {
    int j[kCols];
    bool ok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      j[c] = j0 + c * nt + t;
      ok[c] = j[c] < Lo;
    }
    int32_t acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0;
    }
    for (int i = 0; i < Lx; ++i) {
      int32_t tv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        tv[c] = ok[c] ? __ldg(T + static_cast<int64_t>(i) * Lo + j[c]) : 0;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t xv = xs[r * Lx + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] += xv * tv[c];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (ok[c]) ys[r * Ls + j[c]] = acc[r][c];
      }
    }
  }
  __syncthreads();

  // carry: thread r ripples row r, least significant limb first
  if (t < nr) {
    int32_t* y = ys + t * Ls;
    int32_t carry = 0;
    for (int k = 0; k < Lo; ++k) {
      const int32_t v = y[k] + carry;
      y[k] = v & 255;
      carry = v >> 8;
    }
  }
  __syncthreads();

  int32_t* dst = out + r0 * Lo;
  for (int k = t; k < nr * Lo; k += nt) {
    const int r = k / Lo;
    dst[k] = ys[r * Ls + (k - r * Lo)];
  }
}

template <int kRows>
size_t smem_bytes(int Lx, int Lo) {
  return static_cast<size_t>(kRows) * (Lx + sum_stride(Lo)) *
         sizeof(int32_t);
}

template <int kRows>
cudaError_t launch(const int32_t* x, const int32_t* T, int32_t* out,
                   int64_t n, int Lx, int Lo, cudaStream_t stream) {
  const int64_t blocks = cdiv(n, kRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int threads = static_cast<int>(cdiv(cdiv(Lo, kCols), 32) * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < kRows) threads = kRows;     // one thread per row to carry
  mul_fixed_kernel<kRows><<<static_cast<unsigned>(blocks), threads,
                            smem_bytes<kRows>(Lx, Lo), stream>>>(
      x, T, out, n, Lx, Lo);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mul_fixed_launch(const void* x, const void* T, void* out,
                                long long n, int Lx, int Lo, void* stream) {
  if (n <= 0 || Lx <= 0 || Lo <= 0 ||
      static_cast<int64_t>(Lx) * 255 * 256 > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* tp = static_cast<const int32_t*>(T);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // as many rows a block as the shared-memory window holds, up to 16
  if (smem_bytes<16>(Lx, Lo) <= kSmemBytes) {
    return launch<16>(xp, tp, op, n, Lx, Lo, s);
  }
  if (smem_bytes<8>(Lx, Lo) <= kSmemBytes) {
    return launch<8>(xp, tp, op, n, Lx, Lo, s);
  }
  if (smem_bytes<4>(Lx, Lo) <= kSmemBytes) {
    return launch<4>(xp, tp, op, n, Lx, Lo, s);
  }
  return cudaErrorInvalidValue;
}
