// Monte-Carlo sequence draws in one launch: probabilities -> CDF -> inverse-
// CDF draws with an in-kernel Philox generator -> class map -> packed codes
// and per-sample residue counts.
//
// Replaces the TPU kernel timed_design_tpu/ops/pallas_sample.py
// (pallas_sample_class_indices) together with what consumes its indices on
// the serving path, sample_sequences_with_metrics up to the metrics
// (timed_design_tpu/sample/sampler.py): the cumulative sum before the draws,
// the rotamer -> amino-acid gather and the one-hot residue counts after.
// The same semantics, not the same blocks:
//   - CDF: each row's running sum accumulated in float64, in order, and each
//     prefix rounded to float32: what torch.cumsum of float32 gives on the
//     CPU, so the plain version there gives the same CDF bit for bit.
//   - Draw (sample s, position l of structure b): Philox4x32-10 keyed on the
//     64-bit seed, counter (l, s, b, 0); u = (x0 >> 8) * 2^-24. The single
//     entry is structure 0, so the batched entry's structure 0 draws what it
//     draws. The class is the count of
//     CDF entries <= u, and 0 where that count reaches C (u past the row's
//     mass), as the reference's argmax form gives.
//   - Code: class_map[class] when a map is given (the 338 -> 20 rotamer
//     table), else the class. Codes are uint8 (uint16 when unmapped classes
//     exceed 255), stored four to a store.
//   - Counts: per sample, the number of codes equal to each of 0..19,
//     accumulated with shared-memory atomics and flushed with one global
//     atomic per (sample, pair of codes) per block. Integer sums are exact
//     in any order.
//
// What bounds it on an H100: at serving shapes (76 positions, 338 classes,
// 100 samples) latency alone -- 118 KB in, 16 KB out and 7.6k draws are far
// below what one launch costs -- so the answer there is to do the whole
// stage in one launch where there were about nine. At (4096, 338, 64)
// memory bounds it (5.5 MB of probabilities, ~1.7 us at 3.35 TB/s), above
// the integer work of 262k Philox blocks and searches (~69 operations a
// draw, ~1.1 us at 16.7 T int32 op/s). What holds it above both is latency
// inside a block, in three phases:
//   - the tile's load: one round trip to L2 or HBM;
//   - the row scan: bit-exactness with the CPU's cumsum rules out a parallel
//     scan, so a row is a chain of C dependent float64 adds. The tile holds
//     doubles, converted once while it is loaded, so no conversion sits on
//     the chain (float64 <-> float32 conversions issue at a quarter of a
//     warp per cycle);
//   - the searches: ceil(log2(C + 1)) dependent steps of random shared-
//     memory reads.
// The design:
//   - A block takes tile_l positions and a chunk of samples; the launcher
//     splits samples only as far as it takes to give each SM work, and
//     never below kMinSamples samples a block, so rows are re-staged from L2
//     at most a few times. tile_l is kMaxTileL = 16 while 16 rows of doubles
//     fit in the shared memory a block may opt into (227 KB on an H100: C up
//     to 1,761), and fewer as C grows, down to one row (C up to 25,257 on an
//     H100, where the counts and the map take the rest). Draws are keyed by
//     position, never by tile, so the codes do not depend on tile_l.
//   - The tile's probabilities arrive by 16-byte loads from one contiguous
//     span (the tile's rows are adjacent in memory), coalesced, into shared
//     rows of odd stride (C | 1 doubles): lanes at the same column of
//     different rows hit different banks.
//   - One thread per row turns it into its CDF in place; meanwhile every
//     other thread draws its first four uniforms, which need no CDF.
//   - Each draw becomes an integer threshold t: (float)cdf <= u exactly when
//     the bits of the double cdf are <= t, so the search compares integers
//     and never rounds a double to float32.
//   - A thread takes four adjacent positions of one sample: four searches
//     interleaved step by step, their probes loaded unconditionally so the
//     four reads are in flight together; then the map, one 4-byte store of
//     four codes, and four shared-memory count atomics. Past the tile's last
//     row a probe reads that row again and its code is neither stored nor
//     counted (tiles of fewer than four rows, a structure's last tile).
//
// The batched entry (td-sample's many structures in one launch) takes every
// structure's rows packed with no padding, (sum L, C), and the (B + 1,)
// offsets where each starts. A tile never crosses a structure's boundary, so
// the one-thread-a-row scan stays as it is. Tile t of the grid belongs to the
// structure b with T_b <= t < T_{b+1}, T_b = b + ceil(offsets[b] / tile_l):
// T rises by at least ceil(L_b / tile_l) from b to b + 1, so every tile of b
// has its own t, and the at most B values of t that fall in the gaps exit
// at once. A block finds its b by checking every b once, spread over its
// threads. Codes go to the columns offsets[b]: of an (n, sum L) matrix,
// counts to row b * n + s of a (B * n, 20) one; the four-code store is used
// where the structure's start, its length, sum L and tile_l are multiples of
// 4.
//
// The plain PyTorch versions are sample_codes_plain and
// sample_codes_plain_batched in timed_design_tpu_torch/ops/sample.py, run on
// philox_uniforms and philox_uniforms_batched; they give the same codes and
// counts.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTileL = 16;     // positions per block, at most
constexpr int kThreads = 256;
constexpr int kMinSamples = 32;   // samples per block, at least ...
constexpr int kMaxSamples = 64;   // ... and at most (the counts' shared tile)
constexpr int kCounts = 20;       // counted codes: the 20 amino acids
constexpr int kFound = 3;         // the batched entry's block: b, start, L

__device__ __forceinline__ uint32_t philox_x0(uint32_t l, uint32_t s, uint32_t b,
                                              uint32_t k0, uint32_t k1) {
  uint32_t c0 = l, c1 = s, c2 = b, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// The draw's threshold, as the bits of a double: the largest double t such
// that float32(x) <= u for every double x <= t, under round-to-nearest-even.
// It is the midpoint m between u and the next float32 above u when u's last
// mantissa bit is even (a tie rounds down to u), else the double just below
// m. So (float)cdf <= u exactly when cdf <= t, and for the non-negative
// doubles of the tile that is an integer comparison of their bits. Built
// from x's top 24 bits with integer operations only: u = k * 2^-24 with
// k = x >> 8 has the float32 exponent e - 24, e = floor(log2 k), and its
// last mantissa bit is k's when e == 23, else 0; half of its float32 ulp is
// 2^28 in the units of the double's mantissa.
__device__ __forceinline__ long long draw_threshold(uint32_t x) {
  const uint32_t k = x >> 8;
  if (k == 0) return static_cast<long long>(1023 - 150) << 52;  // u = 0: m = 2^-150
  const int e = 31 - __clz(k);
  const long long u_bits = (static_cast<long long>(1023 + e - 24) << 52) |
                           ((static_cast<long long>(k) << (52 - e)) & ((1LL << 52) - 1));
  const long long m_bits = u_bits + (1LL << 28);
  return (e == 23 && (k & 1u)) ? m_bits - 1 : m_bits;
}

// Thresholds of the draws of positions l0 + 4 * quad + j of sample s of
// structure b.
__device__ __forceinline__ void draw4(int l0, int quad, int s, int b, uint32_t k0,
                                      uint32_t k1, long long t[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = draw_threshold(philox_x0(static_cast<uint32_t>(l0 + 4 * quad + j),
                                    static_cast<uint32_t>(s), static_cast<uint32_t>(b),
                                    k0, k1));
  }
}

template <typename Code>
struct Pack4;
template <>
struct Pack4<uint8_t> {
  using type = uchar4;
  static __device__ uchar4 make(const int c[4]) {
    return make_uchar4(c[0], c[1], c[2], c[3]);
  }
};
template <>
struct Pack4<uint16_t> {
  using type = ushort4;
  static __device__ ushort4 make(const int c[4]) {
    return make_ushort4(c[0], c[1], c[2], c[3]);
  }
};

// kBatched: probs holds B structures packed at `offsets`, and `total` is
// their summed length; else one structure of length `total`.
template <typename Code, bool kBatched>
__global__ void __launch_bounds__(kThreads)
sample_inverse_cdf_kernel(const float* __restrict__ probs,
                          const int32_t* __restrict__ offsets, int B,
                          const uint8_t* __restrict__ class_map,
                          Code* __restrict__ codes, int32_t* __restrict__ counts,
                          int total, int C, int stride, int tile_l, int top, int n,
                          int samples_per_block, uint32_t key0, uint32_t key1) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* tile = reinterpret_cast<double*>(smem);                    // [tile_l][stride]
  int* cnt = reinterpret_cast<int*>(tile + tile_l * stride);         // [samples][20]
  uint8_t* map = reinterpret_cast<uint8_t*>(cnt + kMaxSamples * kCounts);  // [C]
  int* found = reinterpret_cast<int*>(map + ((C + 3) & ~3));          // [kFound]

  // the block's structure b, where its rows start, its length L, and the
  // tile's first position l0 within it
  int b = 0, start = 0, L = total, l0 = blockIdx.y * tile_l;
  const int tid = threadIdx.x;
  if constexpr (kBatched) {
    const int t = blockIdx.y;
    for (int i = tid; i < B; i += kThreads) {
      const int o0 = __ldg(offsets + i), o1 = __ldg(offsets + i + 1);
      if (i + (o0 + tile_l - 1) / tile_l <= t && t < i + 1 + (o1 + tile_l - 1) / tile_l) {
        found[0] = i;
        found[1] = o0;
        found[2] = o1 - o0;
      }
    }
    __syncthreads();
    b = found[0];
    start = found[1];
    L = found[2];
    l0 = (t - b - (start + tile_l - 1) / tile_l) * tile_l;
    if (l0 >= L) return;  // a tile between two structures: the whole block
  }
  const int rows = min(tile_l, L - l0);
  const int s0 = blockIdx.x * samples_per_block;
  const int samples = min(samples_per_block, n - s0);

  // 1. stage the tile's probabilities (rows * C contiguous floats, 16-byte
  //    loads where the span is aligned) as doubles, in rows of odd stride
  const float* src = probs + static_cast<size_t>(start + l0) * C;
  const int total_in = rows * C;
  int first_scalar = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = total_in >> 2;
    for (int i = tid; i < n4; i += kThreads) {
      const float4 v = __ldg(src4 + i);
      int r = (4 * i) / C, c = 4 * i - r * C;
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tile[r * stride + c] = static_cast<double>(e[j]);
        if (++c == C) {
          c = 0;
          ++r;
        }
      }
    }
    first_scalar = n4 << 2;
  }
  for (int i = first_scalar + tid; i < total_in; i += kThreads) {
    const int r = i / C;
    tile[r * stride + (i - r * C)] = static_cast<double>(__ldg(src + i));
  }
  for (int i = tid; i < samples * kCounts; i += kThreads) cnt[i] = 0;
  if (class_map != nullptr) {
    for (int i = tid; i < C; i += kThreads) map[i] = class_map[i];
  }
  __syncthreads();

  // 2. each row's running sum in place, one thread a row, while the other
  //    threads draw their first uniforms
  if (tid < rows) {
    double* row = tile + tid * stride;
    double acc = 0.0;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      acc += row[c];
      row[c] = acc;
    }
  }
  const int quads = (rows + 3) >> 2;
  const int items = samples * quads;
  long long t[4];
  int item = tid;
  if (item < items) draw4(l0, item % quads, s0 + item / quads, b, key0, key1, t);
  __syncthreads();

  // 3. four searches per item, the map, one packed store (where every
  //    quad's four codes are the structure's and 4-aligned), the counts
  const bool packed = ((total | start | L | tile_l) & 3) == 0;
  for (; item < items; item += kThreads) {
    const int sl = item / quads;
    const int quad = item - sl * quads;
    const double* row[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) row[j] = tile + min(4 * quad + j, rows - 1) * stride;
    int k[4] = {0, 0, 0, 0};
    for (int step = top; step > 0; step >>= 1) {
      // the four probes load unconditionally (clamped into the tile), so
      // their shared-memory reads are in flight together
      long long v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = __double_as_longlong(row[j][min(k[j] + step, C) - 1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k[j] + step <= C && v[j] <= t[j]) k[j] += step;
      }
    }
    int code[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cls = k[j] >= C ? 0 : k[j];
      code[j] = class_map != nullptr ? map[cls] : cls;
    }
    const int l = l0 + 4 * quad;
    Code* dst = codes + static_cast<size_t>(s0 + sl) * total + start + l;
    if (packed) {
      *reinterpret_cast<typename Pack4<Code>::type*>(dst) = Pack4<Code>::make(code);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * quad + j < rows) {
        if (!packed) dst[j] = static_cast<Code>(code[j]);
        if (code[j] < kCounts) atomicAdd(&cnt[sl * kCounts + code[j]], 1);
      }
    }
    const int next = item + kThreads;
    if (next < items) draw4(l0, next % quads, s0 + next / quads, b, key0, key1, t);
  }
  __syncthreads();

  // 4. flush: one 64-bit atomic per (sample, pair of codes) that this block
  //    saw. A sample's row of 20 int32 counts is 80 bytes, so pairs are
  //    8-byte aligned; a count stays below 2^31, so no carry crosses a pair.
  unsigned long long* dst = reinterpret_cast<unsigned long long*>(
      counts + (static_cast<size_t>(b) * n + s0) * kCounts);
  for (int i = tid; i < samples * kCounts / 2; i += kThreads) {
    const unsigned int lo = cnt[2 * i], hi = cnt[2 * i + 1];
    if (lo | hi) atomicAdd(dst + i, (static_cast<unsigned long long>(hi) << 32) | lo);
  }
}

// Shared memory of a block for C classes and tile_l rows, all of it
// dynamic: the tile of running sums (double, odd row stride), the counts of
// kMaxSamples samples, the class map and (batched) the block's structure.
long long smem_bytes(int C, int tile_l) {
  return static_cast<long long>(tile_l) * (C | 1) * 8 + kMaxSamples * kCounts * 4 +
         ((C + 3) & ~3) + kFound * 4;
}

}  // namespace

// The shared memory a block of `device` may opt into
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 bytes on an H100), or -1
// on a CUDA error.
extern "C" int sample_inverse_cdf_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Rows of a tile for C classes within smem_max bytes of shared memory:
// kMaxTileL while they fit, fewer as C grows; 0 when one row does not fit
// (the wrapper then refuses C).
extern "C" int sample_inverse_cdf_tile_rows(int C, int smem_max) {
  const long long fixed = smem_bytes(C, 0);
  const long long rows = (smem_max - fixed) / (static_cast<long long>(C | 1) * 8);
  return smem_max < fixed ? 0 : static_cast<int>(rows < kMaxTileL ? rows : kMaxTileL);
}

namespace {

constexpr int kDefaultSmem = 48 * 1024;  // a block's shared memory unasked
constexpr int kMaxDevices = 64;

// Lets the kernel instance take all the dynamic shared memory a block of
// the current device may opt into beside its static shared memory, once per
// instance and device: a launch past 48 KB needs it. Once, and not at every
// launch, so that no attribute is set while a CUDA graph captures the
// launches. (Templated on the instance, not on the kernel's type, which
// both entries share.)
template <typename Code, bool kBatched>
cudaError_t raise_smem() {
  const auto kernel = sample_inverse_cdf_kernel<Code, kBatched>;
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < kMaxDevices && raised[device])) return err;
  const int optin = sample_inverse_cdf_smem_optin(device);
  if (optin < 0) return cudaGetLastError();
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && device < kMaxDevices) raised[device] = true;
  return err;
}

template <typename Code, bool kBatched>
int launch_kernel(dim3 grid, size_t smem, cudaStream_t st, const float* p, const int32_t* o,
                  int B, const uint8_t* m, void* codes, int32_t* k, int total, int C,
                  int tile_l, int top, int n, int per_block, unsigned int key0,
                  unsigned int key1) {
  const auto kernel = sample_inverse_cdf_kernel<Code, kBatched>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = raise_smem<Code, kBatched>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(p, o, B, m, static_cast<Code*>(codes), k, total, C,
                                       C | 1, tile_l, top, n, per_block, key0, key1);
  return static_cast<int>(cudaGetLastError());
}

// Zeroes the B * n rows of counts, then one launch over `tiles` tiles of
// tile_l rows.
template <bool kBatched>
int launch(const void* probs, const void* offsets, int B, const void* class_map,
           void* codes, void* counts, int total, int tiles, int tile_l, int C, int n,
           int code_bytes, unsigned int key0, unsigned int key1, int num_sms,
           cudaStream_t st) {
  cudaMemsetAsync(counts, 0, static_cast<size_t>(B) * n * kCounts * sizeof(int32_t), st);
  // samples a block: enough blocks for every SM, within [kMin, kMax]
  const int want_chunks = (num_sms + tiles - 1) / tiles;
  int per_block = (n + want_chunks - 1) / want_chunks;
  per_block = per_block < kMinSamples ? kMinSamples : per_block;
  per_block = per_block > kMaxSamples ? kMaxSamples : per_block;
  const dim3 grid((n + per_block - 1) / per_block, tiles);
  int top = 1;
  while (2 * top <= C) top *= 2;
  const size_t smem = static_cast<size_t>(smem_bytes(C, tile_l));
  const float* p = static_cast<const float*>(probs);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  const uint8_t* m = static_cast<const uint8_t*>(class_map);
  int32_t* k = static_cast<int32_t*>(counts);
  return code_bytes == 1
             ? launch_kernel<uint8_t, kBatched>(grid, smem, st, p, o, B, m, codes, k, total,
                                                C, tile_l, top, n, per_block, key0, key1)
             : launch_kernel<uint16_t, kBatched>(grid, smem, st, p, o, B, m, codes, k,
                                                 total, C, tile_l, top, n, per_block, key0,
                                                 key1);
}

}  // namespace

// probs: (L, C) float32, contiguous, rows of non-negative values.
// class_map: (C,) uint8 codes on the device, or null.
// codes: (n, L) uint8, or uint16 when code_bytes == 2. counts: (n, 20) int32.
// tile_l: rows a block, from sample_inverse_cdf_tile_rows (1..16).
// Zeroes counts, then launches one kernel, both on `stream`; allocates
// nothing. num_sms: the device's SM count, to size the grid. Returns
// cudaGetLastError(), or the error of raising the block's shared memory.
extern "C" int sample_inverse_cdf(const void* probs, const void* class_map,
                                  void* codes, void* counts, int L, int C, int n,
                                  int code_bytes, int tile_l, unsigned int key0,
                                  unsigned int key1, int num_sms, void* stream) {
  return launch<false>(probs, nullptr, 1, class_map, codes, counts, L,
                       (L + tile_l - 1) / tile_l, tile_l, C, n, code_bytes, key0, key1,
                       num_sms, static_cast<cudaStream_t>(stream));
}

// probs: (total, C) float32, B structures' rows packed with no padding.
// offsets: (B + 1,) int32 on the device, offsets[0] = 0, non-decreasing,
// offsets[B] = total. codes: (n, total), structure b at columns
// offsets[b]:offsets[b + 1]. counts: (B * n, 20) int32, structure b's
// samples at rows b * n + s. Otherwise as sample_inverse_cdf: one memset,
// one launch, nothing allocated.
extern "C" int sample_inverse_cdf_batched(const void* probs, const void* offsets, int B,
                                          const void* class_map, void* codes,
                                          void* counts, int total, int C, int n,
                                          int code_bytes, int tile_l, unsigned int key0,
                                          unsigned int key1, int num_sms, void* stream) {
  return launch<true>(probs, offsets, B, class_map, codes, counts, total,
                      B + (total + tile_l - 1) / tile_l, tile_l, C, n, code_bytes, key0,
                      key1, num_sms, static_cast<cudaStream_t>(stream));
}
