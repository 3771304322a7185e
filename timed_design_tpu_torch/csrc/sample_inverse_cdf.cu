// Categorical draws by inverse CDF with an in-kernel Philox generator.
//
// Replaces the TPU kernel timed_design_tpu/ops/pallas_sample.py
// (pallas_sample_class_indices): the same semantics, not the same blocks.
// For each draw (sample s, position l) a uniform u in [0, 1) with 24 random
// bits is taken from Philox4x32-10 keyed on the 64-bit seed with counter
// (l, s, 0, 0); the class is the count of CDF entries <= u, found by an
// upper-bound binary search over the position's CDF row (equal to the count
// because the row is non-decreasing). A u past the row's mass (count == C)
// gives class 0, as the reference's argmax form does.
//
// What bounds it: memory and latency, not arithmetic. A block reads the CDF
// rows of its 32 positions (32 * C * 4 bytes, 43 KB at C = 338) once into
// shared memory and writes n * 32 * 4 bytes of indices; each draw costs one
// Philox block (20 32-bit multiplies) and ceil(log2(C + 1)) shared-memory
// reads. One thread per draw; the 32 threads of a warp take the 32 positions
// of one sample, so the stores of a warp are one contiguous 128-byte line.
//
// The plain PyTorch version is timed_design_tpu_torch/ops/sample.py
// (sample_class_indices_plain over philox_uniforms), which reproduces this
// kernel's draws index for index.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileL = 32;             // positions per block: one per lane
constexpr int kThreads = 256;          // 8 warps, one sample each per step
constexpr int kSamplesPerBlock = 32;   // samples a block draws per position

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
sample_inverse_cdf_kernel(const float* __restrict__ cdf,
                          int32_t* __restrict__ out, int L, int C, int n,
                          uint32_t key0, uint32_t key1) {
  extern __shared__ float tile[];  // [rows][C]
  const int l0 = blockIdx.y * kTileL;
  const int rows = min(kTileL, L - l0);
  const float* src = cdf + static_cast<size_t>(l0) * C;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) tile[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x % kTileL;
  if (lane >= rows) return;
  const int l = l0 + lane;
  const float* row = tile + lane * C;
  const int s_end = min(n, (blockIdx.x + 1) * kSamplesPerBlock);
  for (int s = blockIdx.x * kSamplesPerBlock + threadIdx.x / kTileL; s < s_end;
       s += kThreads / kTileL) {
    const uint4 x = philox4x32_10(
        make_uint4(static_cast<uint32_t>(l), static_cast<uint32_t>(s), 0u, 0u),
        make_uint2(key0, key1));
    const float u = static_cast<float>(x.x >> 8) * (1.0f / 16777216.0f);
    int lo = 0, hi = C;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] <= u) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[static_cast<size_t>(s) * L + l] = lo >= C ? 0 : lo;
  }
}

}  // namespace

// cdf: (L, C) float32, contiguous, rows non-decreasing, C <= 384 so that the
// tile fits the 48 KB a block gets without raising its shared-memory limit.
// out: (n, L) int32. Launches on `stream` and allocates nothing. Returns
// cudaGetLastError().
extern "C" int sample_inverse_cdf(const void* cdf, void* out, int L, int C,
                                  int n, unsigned int key0, unsigned int key1,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(kTileL) * C * sizeof(float);
  const dim3 grid((n + kSamplesPerBlock - 1) / kSamplesPerBlock,
                  (L + kTileL - 1) / kTileL);
  sample_inverse_cdf_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cdf), static_cast<int32_t*>(out), L, C, n,
      key0, key1);
  return static_cast<int>(cudaGetLastError());
}
