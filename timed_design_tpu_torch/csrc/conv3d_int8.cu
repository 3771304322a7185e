// Int8 3D convolution with int32 accumulation: int8 codes in, int32 sums out.
//
// What it stands for: the integer convolution of the JAX package's `int8`
// quantize mode, timed_design_tpu/models/quantize.py:125-131, which XLA runs
// as conv_general_dilated on int8 operands with preferred_element_type int32.
// It is not the port of a Pallas kernel. PyTorch has no int8 conv3d on CUDA,
// so this is the only route the mode has on the card. The rescale to floating
// point and the bias stay in PyTorch (models/quantize.py of the port), so the
// kernel's output can be held bit for bit to its plain version,
// conv3d_int8_plain in timed_design_tpu_torch/ops/conv3d_int8.py (float64
// conv3d on the codes: every sum is an integer below 2^31, exact in float64).
//
// Layouts: x (B, D, H, W, C) int8, channels last; w (N, k, k, k, C) int8;
// out (B, D', H', W', N) int32 with D' = D + 2 pad - k + 1. Stride 1.
//
// The design, an implicit GEMM:
//   - M = B D' H' W' output positions, N output channels, K = k^3 C, the
//     reduction index kk = tap * C + c (tap = (dz k + dy) k + dx): w's rows
//     are then [N][K] row-major as they lie in memory.
//   - A block owns a 128 x 64 tile of the output. Per step of 32 along K, its
//     256 threads gather the A tile (128 positions x 32 taps-and-channels)
//     from x, the padding's taps and the tail past K read as 0, and the B
//     tile (64 channels x 32) from w, into shared memory. A thread gathers
//     the same output position at every step, so it splits its row index
//     into (b, z, y, x) once. Rows of shared memory are 48 bytes apart: the
//     fragment reads of a warp then hit 32 different banks.
//   - Two shared buffers: the next step's gather is issued into registers
//     before the current step's products, and stored after them; one
//     barrier per step.
//   - Eight warps, each a 32 x 32 piece of the tile: per step 2 x 4
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the integer tensor
//     cores, the sums in registers.
//   - The epilogue stores int32, masked at the ragged edges of M and N.
//   - The gather's width follows C and the pointers' alignment: 16 bytes
//     when C is a multiple of 16 (TIMED's 16..256 channels), 4 when a
//     multiple of 4 (DenseNet's 36, 60, ...), else one byte (5 input
//     channels): a piece of that width never crosses a tap.
//
// What bounds it on an H100: at TIMED's widths at batch 512 the products
// (2 M N K operations over 1,979 T int8 op/s; 2.10 T for the 64 -> 128 block,
// 1.06 ms) or, for the 338-class head, the int32 output (6.41 GB over
// 3.35 TB/s, 1.9 ms). This first kernel is simple rather than fast: mma.sync
// instead of wgmma, gathers through registers instead of TMA or cp.async, a
// two-stage pipeline, a fixed 128 x 64 tile (wasteful for N = 16 or 20), and
// an int32 output that a fused rescale-and-cast epilogue would remove.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;      // output positions per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // reduction depth per step (one mma k-step)
constexpr int kThreads = 256;
constexpr int kRow = 48;      // bytes per shared row: 32 of data, 16 of pad

struct Conv {
  const int8_t* x;
  const int8_t* w;
  int32_t* out;
  int D, H, W, C, Do, Ho, Wo, N, k, pad, K;
  long long M;
};

// The address of row (b, z, y, x)'s piece at reduction index kk, or null
// where the tap falls in the padding or kk >= K. The caller's piece width
// divides C and kk, so the piece lies in one tap.
__device__ __forceinline__ const int8_t* a_piece(const Conv& p, bool row_ok, int b, int z,
                                                 int y, int x, int kk) {
  if (!row_ok || kk >= p.K) return nullptr;
  const int tap = kk / p.C;
  const int c = kk - tap * p.C;
  const int dz = tap / (p.k * p.k);
  const int r = tap - dz * p.k * p.k;
  const int dy = r / p.k;
  const int dx = r - dy * p.k;
  const int iz = z + dz - p.pad, iy = y + dy - p.pad, ix = x + dx - p.pad;
  if ((unsigned)iz >= (unsigned)p.D || (unsigned)iy >= (unsigned)p.H ||
      (unsigned)ix >= (unsigned)p.W)
    return nullptr;
  return p.x + ((((long long)b * p.D + iz) * p.H + iy) * p.W + ix) * p.C + c;
}

// A thread's 16 bytes of the A tile: row (b, z, y, x), reduction indices
// kk0 .. kk0 + 15.
template <int V>
__device__ __forceinline__ uint4 gather_a(const Conv& p, bool row_ok, int b, int z, int y,
                                          int x, int kk0) {
  uint32_t r[4] = {0u, 0u, 0u, 0u};
  if constexpr (V == 16) {
    const int8_t* s = a_piece(p, row_ok, b, z, y, x, kk0);
    if (s) return *reinterpret_cast<const uint4*>(s);
  } else if constexpr (V == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int8_t* s = a_piece(p, row_ok, b, z, y, x, kk0 + 4 * q);
      if (s) r[q] = *reinterpret_cast<const uint32_t*>(s);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int8_t* s = a_piece(p, row_ok, b, z, y, x, kk0 + q);
      if (s) r[q >> 2] |= (uint32_t)(uint8_t)*s << (8 * (q & 3));
    }
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// A thread's 8 bytes of the B tile: channel n, reduction indices kk0 .. +7,
// read in pieces of min(V, 8) bytes (K is a multiple of V).
template <int V>
__device__ __forceinline__ uint2 gather_b(const Conv& p, int n, int kk0) {
  uint32_t r[2] = {0u, 0u};
  if (n >= p.N) return make_uint2(0u, 0u);
  const int8_t* row = p.w + (long long)n * p.K;
  if constexpr (V >= 8) {
    if (kk0 < p.K) return *reinterpret_cast<const uint2*>(row + kk0);
  } else if constexpr (V == 4) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (kk0 + 4 * q < p.K) r[q] = *reinterpret_cast<const uint32_t*>(row + kk0 + 4 * q);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (kk0 + q < p.K) r[q >> 2] |= (uint32_t)(uint8_t)row[kk0 + q] << (8 * (q & 3));
  }
  return make_uint2(r[0], r[1]);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int V>
__global__ void __launch_bounds__(kThreads) conv3d_int8_kernel(const Conv p) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's gather: A row tid / 2, bytes (tid % 2) * 16 .. +15 of the
  // step; B row tid / 4, bytes (tid % 4) * 8 .. +7
  const int ra = tid >> 1, ka = (tid & 1) * 16;
  const int rb = tid >> 2, kb = (tid & 3) * 8;
  const long long m = m0 + ra;
  const bool row_ok = m < p.M;
  int b = 0, z = 0, y = 0, x = 0;
  if (row_ok) {
    long long q = m;
    x = (int)(q % p.Wo);
    q /= p.Wo;
    y = (int)(q % p.Ho);
    q /= p.Ho;
    z = (int)(q % p.Do);
    b = (int)(q / p.Do);
  }

  // this thread's fragments: its warp owns rows wm .. wm + 31 and columns
  // wn .. wn + 31 of the tile; lane = 4 g + t in the mma's layout
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int g = lane >> 2, t = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (p.K + kBK - 1) / kBK;
  uint4 va = gather_a<V>(p, row_ok, b, z, y, x, ka);
  uint2 vb = gather_b<V>(p, n0 + rb, kb);
  *reinterpret_cast<uint4*>(&As[0][ra * kRow + ka]) = va;
  *reinterpret_cast<uint2*>(&Bs[0][rb * kRow + kb]) = vb;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      va = gather_a<V>(p, row_ok, b, z, y, x, (s + 1) * kBK + ka);
      vb = gather_b<V>(p, n0 + rb, (s + 1) * kBK + kb);
    }
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = &As[cur][(wm + i * 16 + g) * kRow + t * 4];
      const int8_t* r8 = r0 + 8 * kRow;
      af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* c0 = &Bs[cur][(wn + j * 8 + g) * kRow + t * 4];
      bf[j][0] = *reinterpret_cast<const uint32_t*>(c0);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    if (more) {
      *reinterpret_cast<uint4*>(&As[cur ^ 1][ra * kRow + ka]) = va;
      *reinterpret_cast<uint2*>(&Bs[cur ^ 1][rb * kRow + kb]) = vb;
    }
    __syncthreads();
  }

  // acc[i][j]: rows wm + 16 i + g (+8 for e >= 2), columns wn + 8 j + 2 t (+1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + i * 16 + g + h * 8;
      if (row >= p.M) continue;
      int32_t* o = p.out + row * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (col < p.N) o[col] = acc[i][j][2 * h];
        if (col + 1 < p.N) o[col + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

}  // namespace

// Launches the convolution on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). The caller checks the shapes, that pad is 0 or
// (k - 1) / 2, that the output is not empty and that k^3 C 127^2 < 2^31.
extern "C" int conv3d_int8(const void* x, const void* w, void* out, int B, int D, int H, int W,
                           int C, int N, int k, int pad, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = static_cast<int32_t*>(out);
  p.D = D;
  p.H = H;
  p.W = W;
  p.C = C;
  p.N = N;
  p.k = k;
  p.pad = pad;
  p.Do = D + 2 * pad - k + 1;
  p.Ho = H + 2 * pad - k + 1;
  p.Wo = W + 2 * pad - k + 1;
  p.K = k * k * k * C;
  p.M = (long long)B * p.Do * p.Ho * p.Wo;
  const long long blocks_m = (p.M + kBM - 1) / kBM;
  if (blocks_m > 0x7fffffffLL || (N + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_m, (N + kBN - 1) / kBN);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 16 == 0 && align % 16 == 0)
    conv3d_int8_kernel<16><<<grid, kThreads, 0, s>>>(p);
  else if (C % 4 == 0 && align % 4 == 0)
    conv3d_int8_kernel<4><<<grid, kThreads, 0, s>>>(p);
  else
    conv3d_int8_kernel<1><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
