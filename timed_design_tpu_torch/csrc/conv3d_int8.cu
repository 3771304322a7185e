// Int8 3D convolution on Hopper's tensor cores: int8 codes in, and out either
// the int32 sums or, fused into the same launch, the rescaled sums plus a bias
// in float32, bfloat16 or float16.
//
// What it stands for: the integer convolution of the JAX package's `int8`
// quantize mode, timed_design_tpu/models/quantize.py:125-138, which XLA runs
// as conv_general_dilated on int8 operands with preferred_element_type int32
// and then rescales, `(acc.astype(f32) * scale).astype(lhs.dtype)`, before
// Flax's bias add. It is not the port of a Pallas kernel: PyTorch has no int8
// conv3d on CUDA, so this is the only route the mode has on the card. Its plain
// version is conv3d_int8_plain in timed_design_tpu_torch/ops/conv3d_int8.py
// (float64 conv3d on the codes, exact below 2^31, then the same PyTorch ops
// as the epilogue), which the kernel equals bit for bit.
//
// Layouts: x (B, D, H, W, C) int8, channels last, C a multiple of 4 (the
// wrapper pads other C with zero channels, 5 -> 8); w (Np, Kp) int8, output
// channel n's k^3 C codes in tap-major order (kk = tap C + c, tap = (dz k +
// dy) k + dx), zero past N and past K = k^3 C up to Kp, a multiple of 128;
// out (B, D', H', W', N), D' = D + 2 pad - k + 1, stride 1. With a scale,
// each value is round(float(acc) * scale[n]) to the output type and, with a
// bias, round(float(that) + float(bias[n])): the rounding of PyTorch's
// `acc.to(float32).mul_(scale).to(dt) + bias` step by step, so the epilogue
// uses the _rn intrinsics and nvcc cannot contract the two into one FMA.
//
// What bounds it on an H100 at TIMED's widths at batch 512: the bytes (the
// codes read once and the output written once, 2 bytes a value in bfloat16,
// over 3.35 TB/s) for the first two blocks and both heads; the products (2 M
// N K over 1,979 T int8 op/s) for the 32 -> 64 and 64 -> 128 blocks.
//
// The design, an implicit GEMM: M = B D' H' W' output positions, N output
// channels, K = k^3 C. A block of 256 threads computes tiles of 128 positions
// and BN channels. It is persistent (as many blocks as fit on the SMs, each
// walking tiles i, i + gridDim.x, ...); there is no producer warp and no
// setmaxnreg: both warpgroups copy and both multiply.
//   - Products: wgmma.mma_async m64nBNk32 .s32.s8.s8, A and B both read from
//     shared memory through matrix descriptors, each warpgroup 64 of the
//     rows; the sums stay in registers. Both operands are K-major, as 8-bit
//     wgmma requires: a position's taps-and-channels and w's rows.
//   - Tiles in shared memory: 128 bytes of K per stage in the canonical
//     128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), so one
//     barrier covers four wgmma k-steps.
//   - A ring of stages (4, or 3 where that lets two blocks share an SM or
//     leaves room for the staged epilogue) filled by cp.async straight to
//     shared memory, no registers in between: the copies of step s + 2 are
//     in flight while step s is multiplied, with 4 stages one wgmma group
//     stays in flight across the barrier, and the ring runs on from one tile
//     into the next. Padding taps and the tail past K
//     are copied with src-size 0 (zero fill); w's padded rows need no mask.
//   - Gather without division in the loop: a thread splits its position into
//     (b, z, y, x) once a tile and walks the taps with counters (c, dx, dy,
//     dz), moving 2 V bytes along K per copy. V is the widest of 16, 8 and 4
//     bytes that divides C, so a copy never crosses a tap; the wrapper pads
//     other C with zero channels (5 -> 8), so no copy is one byte.
//   - BN fits N: one instantiation per width of 16, 24, 32, 48, 64, 128 and
//     176; the wrapper picks the fewest channels, then the fewest column
//     blocks (20 -> 24, 338 -> 2 x 176: its A tile is gathered twice, by
//     neighbouring tiles, so the second gather finds it in L2).
//   - Epilogue from the accumulators: scale, bias and cast, masked at the
//     ragged edges of M and N, with no int32 tensor and no second pass. It
//     stores pairs of values straight from the registers, except for the
//     176-wide tile, which each warp stages in shared memory and stores row
//     by row, 4 bytes a lane (staged() says why).
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;               // output positions per block
constexpr int kSlice = 128;            // bytes of K per stage
constexpr int kThreads = 256;          // two warpgroups
constexpr int kATile = kBM * kSlice;   // bytes of one stage's A tile

enum OutKind { kInt32 = 0, kFloat32 = 1, kBFloat16 = 2, kFloat16 = 3 };

struct Conv {
  const int8_t* x;
  const int8_t* w;
  void* out;
  const float* scale;  // (N,), or null for the int32 sums
  const void* bias;    // (N,) in the output type, or null
  int out_kind;
  int D, H, W, C, Do, Ho, Wo, N, k, pad, Kp, V;
  int M, tiles_m, tiles_n;  // M = B D' H' W' positions, in tiles of 128 x BN
  int out_bytes;            // bytes of one output value
};

// The epilogue goes through shared memory for the widest tile only (the
// 338-class head in two column blocks of 176), where it measured faster than
// storing straight from the registers on an H100 at batch 512; for two
// blocks of 128 (N = 256) it measured slower, and a tile that spans N is
// written in whole sectors either way.
template <int BN>
__host__ __device__ constexpr bool staged() {
  return BN == 176;
}

// bytes of shared memory the staged epilogue takes at most: 16 rows of each
// warp, 4 bytes a value
template <int BN>
__host__ __device__ constexpr int staging_bytes() {
  return staged<BN>() ? kThreads / 32 * 16 * BN * 4 : 0;
}

// Four stages where two blocks still fit on one SM, or where not even three
// do (and four fit beside the staging); else three.
template <int BN>
__host__ __device__ constexpr int stages() {
  constexpr int stage = kATile + BN * kSlice, two_blocks = 113 * 1024;
  if (4 * stage + staging_bytes<BN>() + 1024 > 227 * 1024) return 3;
  return (4 * stage <= two_blocks || 3 * stage > two_blocks) ? 4 : 3;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return stages<BN>() * (kATile + BN * kSlice) + 1024;  // + room to align to 1024
}

constexpr int kPrefetch = 2;  // stages copied ahead of the one multiplied

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V bytes from src to shared dst, or V zero bytes when !full
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(V),
               "r"(full ? V : 0));
}

__device__ __forceinline__ void cp_async_cg16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the copies' writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the sums across wgmma
template <int R>
__device__ __forceinline__ void fence_sums(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Descriptor of a K-major tile in the 128-byte swizzle at shared address
// `addr` (1024-aligned rows of 128 bytes; 8-row groups 1024 bytes apart).
// Adding 2 moves it 32 bytes along K, one wgmma k-step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D (64 x N, s32) += A (64 x 32, s8, K-major) B (N x 32, s8, K-major)^T.
// Thread 32 w + 4 g + t of the warpgroup holds d[4 j + e]: row 16 w + g (+8
// for e >= 2), column 8 j + 2 t + (e & 1).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<24>(int (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<176>(int (&d)[88], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87])
      : "l"(a), "l"(b), "r"(1));
}


// A thread's place along K: channel c of tap (dz, dy, dx)
struct Walk {
  int c, dx, dy, dz;
};

__device__ __forceinline__ void advance(Walk& wk, int bytes, int C, int k) {
  wk.c += bytes;
  while (wk.c >= C) {
    wk.c -= C;
    if (++wk.dx == k) {
      wk.dx = 0;
      if (++wk.dy == k) {
        wk.dy = 0;
        ++wk.dz;
      }
    }
  }
}

// A thread's copies into one stage's A tile: row `ra` (position b, z, y, x),
// pieces h, h + 2, h + 4, ... of V bytes; its walk moves 2 V bytes a piece.
template <int V>
__device__ __forceinline__ void load_a(const Conv& p, uint32_t tile, int ra, int h, bool row_ok,
                                       const int8_t* xb, int z, int y, int x, Walk& wk) {
#pragma unroll
  for (int j = 0; j < 64 / V; ++j) {
    const int col = V * (h + 2 * j);
    const uint32_t dst = tile + ra * kSlice + ((((col >> 4) ^ ra) & 7) << 4) + (col & 15);
    const int iz = z + wk.dz - p.pad, iy = y + wk.dy - p.pad, ix = x + wk.dx - p.pad;
    const bool ok = row_ok && wk.dz < p.k && (unsigned)iz < (unsigned)p.D &&
                    (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
    const int8_t* src = ok ? xb + ((iz * p.H + iy) * p.W + ix) * p.C + wk.c : p.x;
    cp_async<V>(dst, src, ok);
    advance(wk, 2 * V, p.C, p.k);
  }
}

// One stage's B tile: BN rows of w, bytes slice * 128 .. + 127 of each
template <int BN>
__device__ __forceinline__ void load_b(const Conv& p, uint32_t tile, int n0, int slice, int tid) {
  const int8_t* src = p.w + (long long)n0 * p.Kp + slice * kSlice;
#pragma unroll
  for (int q = 0; q < (BN * 8 + kThreads - 1) / kThreads; ++q) {
    const int i = tid + q * kThreads;
    if (i < BN * 8) {
      const int r = i >> 3, ch = i & 7;
      cp_async_cg16(tile + r * kSlice + ((ch ^ (r & 7)) << 4), src + (long long)r * p.Kp + ch * 16);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// A sum as the output type: as it is (int32_t), or rescaled and cast, plus
// the bias cast back from float32 when there is one.
template <typename T>
__device__ __forceinline__ T finish(int acc, float scale, const T* bias, int n) {
  if constexpr (std::is_same<T, int32_t>::value) {
    return acc;
  } else {
    const T v = from_float<T>(__fmul_rn(__int2float_rn(acc), scale));
    return bias ? from_float<T>(__fadd_rn(to_float(v), to_float(bias[n]))) : v;
  }
}

// Two neighbouring values of one output row: one store where they are
// aligned for it, else one or two of their own.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, T v0, T v1, bool both, bool paired) {
  struct alignas(2 * sizeof(T)) Pair {
    T v[2];
  };
  if (both && paired) {
    *reinterpret_cast<Pair*>(dst) = Pair{{v0, v1}};
  } else {
    dst[0] = v0;
    if (both) dst[1] = v1;
  }
}

// The epilogue of one tile. Thread (row, t) holds columns 8 j + 2 t and + 1
// of rows `row` and `row` + 8; warp i holds rows 16 i .. 16 i + 15.
//  - staged: the warp writes its 16 rows into its own piece of shared memory
//    and stores them coalesced: as one contiguous run of the output, 16 bytes
//    a lane, when the tile spans all N columns; else row by row, 4 bytes a
//    lane where the rows allow it;
//  - else straight from the registers, a pair of values a store.
// Masked at the ragged edges of M and N either way.
template <typename T, int BN, bool kStaged>
__device__ __forceinline__ void store_tile(const Conv& p, const int (&acc)[BN / 2], int m0, int n0,
                                           int row, int t, uint8_t* stage) {
  T* out = static_cast<T*>(p.out);
  const T* bias = static_cast<const T*>(p.bias);
  const int ncols = min(BN, p.N - n0);
  const bool paired = p.N % 2 == 0;
  T* tile = reinterpret_cast<T*>(stage);
  const int r = row & 15;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t, n = n0 + c;
    if (c >= ncols) continue;
    const bool both = c + 1 < ncols;
    float s0 = 0.f, s1 = 0.f;
    if constexpr (!std::is_same<T, int32_t>::value) {
      s0 = p.scale[n];
      s1 = both ? p.scale[n + 1] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const T v0 = finish<T>(acc[4 * j + 2 * e], s0, bias, n);
      const T v1 = finish<T>(acc[4 * j + 2 * e + 1], s1, bias, n + 1);
      if (kStaged) {
        tile[(r + 8 * e) * ncols + c] = v0;
        if (both) tile[(r + 8 * e) * ncols + c + 1] = v1;
      } else if (m0 + row + 8 * e < p.M) {
        store_pair(out + (long long)(m0 + row + 8 * e) * p.N + n, v0, v1, both, paired);
      }
    }
  }
  if (!kStaged) return;
  __syncwarp();
  const int lane = threadIdx.x & 31, r0 = m0 + (row & ~15);
  const int rows = min(16, p.M - r0);
  if (ncols == p.N) {  // the warp's rows are one run of the output
    uint8_t* dst = reinterpret_cast<uint8_t*>(out + (long long)r0 * p.N);
    const int bytes = rows > 0 ? rows * p.N * (int)sizeof(T) : 0, vec = bytes / 16;
    for (int i = lane; i < vec; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
    for (int i = vec * 16 / (int)sizeof(T) + lane; i < bytes / (int)sizeof(T); i += 32)
      reinterpret_cast<T*>(dst)[i] = tile[i];
  } else if (sizeof(T) == 2 && paired) {  // rows of 4-byte words
    for (int q = 0; q < rows; ++q) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + (long long)(r0 + q) * p.N + n0);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(tile + q * ncols);
      for (int i = lane; i < ncols / 2; i += 32) dst[i] = src[i];
    }
  } else {
    for (int q = 0; q < rows; ++q) {
      T* dst = out + (long long)(r0 + q) * p.N + n0;
      for (int i = lane; i < ncols; i += 32) dst[i] = tile[q * ncols + i];
    }
  }
  __syncwarp();
}

// blocks of one width that fit on an SM by shared memory, so that the
// compiler keeps to their share of the registers
template <int BN>
__host__ __device__ constexpr int blocks_per_sm() {
  return 2 * smem_bytes<BN>() <= 227 * 1024 ? 2 : 1;
}

// the first output channel of this block's tiles: gridDim.x is a multiple of
// tiles_n, so every tile of a block has the same column block
template <int BN>
__device__ __forceinline__ int column0(const Conv& p) {
  return blockIdx.x % p.tiles_n * BN;
}

// Persistent: block i takes output tiles i, i + gridDim.x, ... (tile = mb
// tiles_n + nb, and gridDim.x a multiple of tiles_n: a block keeps one column
// block, while the column blocks of 128 positions run side by side and their
// A tiles meet in L2). The ring runs on across tiles: the next tile's first
// stages are copied while this one's last are multiplied and stored.
template <int BN, bool kStaged>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<BN>())
    conv3d_int8_kernel(const __grid_constant__ Conv p) {
  constexpr int S = stages<BN>();
  constexpr int kInFlight = S - 1 - kPrefetch;  // wgmma groups left running across a barrier
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1024-aligned tiles

  const int tid = threadIdx.x;
  const int slices = p.Kp / kSlice;
  const int tiles = p.tiles_m * p.tiles_n;
  const int first = blockIdx.x, stride = gridDim.x;
  const int steps = first < tiles ? (tiles - first + stride - 1) / stride * slices : 0;
  constexpr int stage = kATile + BN * kSlice;
  // this thread's copies: A row ra of tile ld_tile, pieces h, h + 2, ...;
  // at each tile's start its position is split once into (b, z, y, x)
  const int ra = tid >> 1, h = tid & 1;
  int ld_tile = first, ld_slice = 0, ld_step = 0, z = 0, y = 0, x = 0;
  bool row_ok = false;
  const int8_t* xb = p.x;
  Walk wk{0, 0, 0, 0};
  auto load_next = [&]() {
    if (ld_slice == 0) {
      const int m = ld_tile / p.tiles_n * kBM + ra;
      row_ok = m < p.M;
      int q = row_ok ? m : 0;
      x = q % p.Wo;
      q /= p.Wo;
      y = q % p.Ho;
      q /= p.Ho;
      z = q % p.Do;
      xb = p.x + (long long)(q / p.Do) * p.D * p.H * p.W * p.C;
      wk = Walk{0, 0, 0, 0};
      advance(wk, h * p.V, p.C, p.k);
    }
    const uint32_t tile = base + (ld_step % S) * stage;
    if (p.V == 16)
      load_a<16>(p, tile, ra, h, row_ok, xb, z, y, x, wk);
    else if (p.V == 8)
      load_a<8>(p, tile, ra, h, row_ok, xb, z, y, x, wk);
    else
      load_a<4>(p, tile, ra, h, row_ok, xb, z, y, x, wk);
    load_b<BN>(p, tile + kATile, column0<BN>(p), ld_slice, tid);
    ++ld_step;
    if (++ld_slice == slices) {
      ld_slice = 0;
      ld_tile += stride;
    }
  };

#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    if (s < steps) load_next();
    cp_async_commit();
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int wg = tid >> 7;
  for (int tile = first, g = 0; tile < tiles; tile += stride) {
    for (int slice = 0; slice < slices; ++slice, ++g) {
      cp_async_wait<kPrefetch - 1>();  // this thread's copies of step g have landed
      fence_proxy_async();
      __syncthreads();  // everyone's have; and step g + 2's slot is no longer read
      if (g + kPrefetch < steps) load_next();
      cp_async_commit();
      const uint32_t st = base + (g % S) * stage;
      const uint64_t da = sw128_desc(st + wg * 64 * kSlice), db = sw128_desc(st + kATile);
      fence_sums(acc);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kSlice / 32; ++kq) wgmma_s8<BN>(acc, da + 2 * kq, db + 2 * kq);
      wgmma_commit();
      wgmma_wait<kInFlight>();
    }
    wgmma_wait<0>();
    fence_sums(acc);
    // the staged epilogue's 16 rows of each warp lie past the ring
    uint8_t* staging = nullptr;
    if constexpr (kStaged)
      staging = smem_raw + (base - raw) + S * stage + (tid >> 5) * 16 * BN * p.out_bytes;
    const int m0 = tile / p.tiles_n * kBM, n0 = column0<BN>(p);
    const int row = (tid >> 5) * 16 + ((tid & 31) >> 2), t = tid & 3;
    switch (p.out_kind) {
      case kInt32:
        store_tile<int32_t, BN, kStaged>(p, acc, m0, n0, row, t, staging);
        break;
      case kFloat32:
        store_tile<float, BN, kStaged>(p, acc, m0, n0, row, t, staging);
        break;
      case kBFloat16:
        store_tile<__nv_bfloat16, BN, kStaged>(p, acc, m0, n0, row, t, staging);
        break;
      default:
        store_tile<__half, BN, kStaged>(p, acc, m0, n0, row, t, staging);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  }
  cp_async_wait<0>();
}

template <int BN, bool kStaged>
int launch_kernel(const Conv& p, int bytes, cudaStream_t stream) {
  auto kernel = conv3d_int8_kernel<BN, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = std::min((long long)p.tiles_m * p.tiles_n, (long long)per_sm * sms);
  grid = std::max(grid - grid % p.tiles_n, (long long)p.tiles_n);  // one column block a block
  kernel<<<(unsigned)grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BN>
int launch(const Conv& p, cudaStream_t stream) {
  const int bytes = smem_bytes<BN>() + (staged<BN>() ? kThreads / 32 * 16 * BN * p.out_bytes : 0);
  return launch_kernel<BN, staged<BN>()>(p, bytes, stream);
}

}  // namespace

// Launches the convolution on `stream` and returns a CUDA error code (0 when
// the launch was accepted). w is the (bn * ceil(N / bn), Kp) re-laid weight.
// With scale null, out is int32 and bias must be null; else out_kind 1, 2 or
// 3 (float32, bfloat16, float16) and bias, when given, is in that type. The
// caller checks the shapes, that pad is 0 or (k - 1) / 2, that the output is
// not empty and that k^3 C 127^2 < 2^31; C must be a multiple of 4, bn one of
// the instantiated widths and M = B D' H' W' below 2^31.
extern "C" int conv3d_int8(const void* x, const void* w, void* out, const void* scale,
                           const void* bias, int out_kind, int B, int D, int H, int W, int C,
                           int N, int k, int pad, int bn, int Kp, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.scale = static_cast<const float*>(scale);
  p.bias = bias;
  p.out_kind = out_kind;
  p.out_bytes = out_kind == kBFloat16 || out_kind == kFloat16 ? 2 : 4;
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
  p.Kp = Kp;
  p.V = C % 16 == 0 ? 16 : C % 8 == 0 ? 8 : 4;
  const long long M = (long long)B * p.Do * p.Ho * p.Wo;
  p.M = (int)M;
  p.tiles_m = (int)((M + kBM - 1) / kBM);
  p.tiles_n = (N + bn - 1) / bn;
  const bool int_out = out_kind == kInt32;
  if (C % 4 != 0 || reinterpret_cast<uintptr_t>(x) % p.V != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || Kp % kSlice != 0 || Kp < k * k * k * C ||
      M >= (1LL << 31) - kBM || (long long)p.tiles_m * p.tiles_n >= (1LL << 31) ||
      int_out != (scale == nullptr) || (int_out && bias != nullptr) || out_kind < kInt32 ||
      out_kind > kFloat16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch<16>(p, s);
    case 24: return launch<24>(p, s);
    case 32: return launch<32>(p, s);
    case 48: return launch<48>(p, s);
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    case 176: return launch<176>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
