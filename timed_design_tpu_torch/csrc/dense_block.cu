// DenseNet's dense blocks in evaluation: the element-wise passes around the
// convolutions, each one read and one write of the values it touches.
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA, which
// fuses them. They were added because, run as PyTorch operations, the
// passes of a DenseCPD forward are bound by device memory and move several
// times the bytes they need: each BatchNorm-ReLU cast bfloat16 to float32,
// normalised, clamped and cast back, some 28 bytes a value, and every dense
// layer concatenated its input and output into a new tensor. At batch 512
// they held a 100 ms forward whose least time is 4.9 ms. Each pass below
// does a few float32 operations a value, far below the ~295 a byte at which
// an H100's tensor cores become the limit, so the design is about bytes:
//
//   - dense_bn_relu: evaluation-mode BatchNorm and ReLU of the first C
//     channels of a channels-last buffer whose rows hold C_total (the
//     prefix a dense layer reads), written as a contiguous (rows, C) tensor,
//     the input of the next convolution. Optionally the bias of the
//     convolution that produced the input is added first. 2 + 2 bytes a
//     bfloat16 value (4 + 4 in float32; bf16 in, float32 out for the head).
//   - dense_bias_store: a convolution's contiguous (rows, N) output plus its
//     bias, rounded to the buffer's type and stored into channels
//     [c0, c0 + N) of the buffer: the concatenation without a copy of the
//     channels already there.
//   - dense_pool_store: a transition's 2^3 average pool (floor: odd edges
//     drop their last slab) of the 1^3 convolution's output, plus its bias,
//     stored into the first N channels of the next block's buffer.
//
// Arithmetic is float32 whatever the storage, each step rounded on its own
// (__fadd_rn, __fmul_rn: no contraction into an FMA), so that the plain
// PyTorch versions in ops/dense_block.py give the same bits on the CPU and
// on the card: scale = gamma / sqrt(var + eps), shift = beta - mean * scale,
// y = relu(((x + bias) * scale) + shift); a pool sums its eight values in
// (d, h, w) order, times 1/8, plus the bias.
//
// The design: a row of the buffer is one voxel's channels. A thread holds
// one vector of V channels (16 bytes at most: 8 bfloat16 or 4 float32 a
// load) and walks over rows, so its per-channel factors stay in registers,
// computed once a block into shared memory and read from there once a
// thread. A block's threads cover the C / V vectors of a row and as many
// rows as fit in 256 threads; neighbouring threads touch neighbouring
// addresses. Each thread issues the loads of four rows before their
// stores, to keep enough bytes in flight. The launcher picks V from the
// shapes and the pointers' alignment (DenseNet's growth of 12 gives rows
// of 36 or 60 channels: V = 4), and the grid is at most 8 blocks an SM,
// each striding over the rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // rows whose loads a thread issues together
constexpr int kBlocksPerSm = 8;   // 2048 threads an SM
// three float tables in the 48 KB of shared memory a block has unasked;
// ops/dense_block.py's MAX_CHANNELS
constexpr int kMaxChannels = 4096;

enum Kind { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The unsigned type of a load or store of Bytes, so that a Pack moves in
// one instruction (ld.global.v4.u32 for 16 bytes).
template <int Bytes>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  using R = typename Raw<sizeof(Pack<T, V>)>::type;
  const R r = *reinterpret_cast<const R*>(p);
  Pack<T, V> out;
  memcpy(&out, &r, sizeof(R));
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& v) {
  using R = typename Raw<sizeof(Pack<T, V>)>::type;
  R r;
  memcpy(&r, &v, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

// The threads of a block as (vector of a row, row): bx vectors by by rows.
struct Layout {
  int nv, bx, by;
  __host__ __device__ explicit Layout(int channels, int vec)
      : nv(channels / vec), bx(nv < kThreads ? nv : kThreads), by(kThreads / bx) {}
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// (a) y[r, c] = relu(((x[r, c] + bias[c]) * scale[c]) + shift[c]) for the
// first C channels of rows of in_stride values; y is (rows, C) contiguous.
template <typename Tin, typename Tout, int V, bool kBias>
__global__ void __launch_bounds__(kThreads)
    dense_bn_relu(const Tin* __restrict__ x, long long rows, int in_stride, int C,
                  const float* __restrict__ mean, const float* __restrict__ var,
                  const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                  const float* __restrict__ bias, Tout* __restrict__ y) {
  extern __shared__ float table[];  // scale[C], shift[C], bias[C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float s = __fdiv_rn(gamma[c], __fsqrt_rn(__fadd_rn(var[c], eps)));
    table[c] = s;
    table[C + c] = __fsub_rn(beta[c], __fmul_rn(mean[c], s));
    if (kBias) table[2 * C + c] = bias[c];
  }
  __syncthreads();
  const Layout lay(C, V);
  const int tx = threadIdx.x % lay.bx, ty = threadIdx.x / lay.bx;
  if (ty >= lay.by) return;
  const long long step = static_cast<long long>(lay.by) * gridDim.x;
  for (int cv = tx; cv < lay.nv; cv += lay.bx) {
    float s[V], t[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] = table[cv * V + j];
      t[j] = table[C + cv * V + j];
      b[j] = kBias ? table[2 * C + cv * V + j] : 0.f;
    }
    for (long long r = static_cast<long long>(blockIdx.x) * lay.by + ty; r < rows;
         r += kUnroll * step) {
      Pack<Tin, V> in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + u * step;
        if (ru < rows) in[u] = load<Tin, V>(x + ru * in_stride + cv * V);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + u * step;
        if (ru >= rows) break;
        Pack<Tout, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = to_f32(in[u].v[j]);
          if (kBias) v = __fadd_rn(v, b[j]);
          o.v[j] = from_f32<Tout>(relu(__fadd_rn(__fmul_rn(v, s[j]), t[j])));
        }
        store<Tout, V>(y + ru * C + cv * V, o);
      }
    }
  }
}

// (b) out[r, c] = h[r, c] + bias[c] for a contiguous (rows, N) h; out rows
// of out_stride values (the buffer, offset to its first written channel).
template <typename T, int V, bool kBias>
__global__ void __launch_bounds__(kThreads)
    dense_bias_store(const T* __restrict__ h, long long rows, int N,
                     const float* __restrict__ bias, T* __restrict__ out, int out_stride) {
  const Layout lay(N, V);
  const int tx = threadIdx.x % lay.bx, ty = threadIdx.x / lay.bx;
  if (ty >= lay.by) return;
  const long long step = static_cast<long long>(lay.by) * gridDim.x;
  for (int cv = tx; cv < lay.nv; cv += lay.bx) {
    float b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = kBias ? bias[cv * V + j] : 0.f;
    for (long long r = static_cast<long long>(blockIdx.x) * lay.by + ty; r < rows;
         r += kUnroll * step) {
      Pack<T, V> in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + u * step;
        if (ru < rows) in[u] = load<T, V>(h + ru * N + cv * V);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + u * step;
        if (ru >= rows) break;
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = to_f32(in[u].v[j]);
          o.v[j] = from_f32<T>(kBias ? __fadd_rn(v, b[j]) : v);
        }
        store<T, V>(out + ru * out_stride + cv * V, o);
      }
    }
  }
}

// (c) out[b, i, j, k, c] = mean of h[b, 2i + {0,1}, 2j + {0,1}, 2k + {0,1}, c]
// + bias[c], for a contiguous (B, D, H, W, N) h; out rows (B, D/2, H/2, W/2)
// of out_stride values.
template <typename T, int V, bool kBias>
__global__ void __launch_bounds__(kThreads)
    dense_pool_store(const T* __restrict__ h, int B, int D, int H, int W, int N,
                     const float* __restrict__ bias, T* __restrict__ out, int out_stride) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const long long rows = static_cast<long long>(B) * Do * Ho * Wo;
  const long long plane = static_cast<long long>(H) * W * N, line = static_cast<long long>(W) * N;
  const Layout lay(N, V);
  const int tx = threadIdx.x % lay.bx, ty = threadIdx.x / lay.bx;
  if (ty >= lay.by) return;
  const long long step = static_cast<long long>(lay.by) * gridDim.x;
  for (int cv = tx; cv < lay.nv; cv += lay.bx) {
    float b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = kBias ? bias[cv * V + j] : 0.f;
    for (long long r = static_cast<long long>(blockIdx.x) * lay.by + ty; r < rows; r += step) {
      long long q = r;
      const int k = static_cast<int>(q % Wo);
      q /= Wo;
      const int j = static_cast<int>(q % Ho);
      q /= Ho;
      const int i = static_cast<int>(q % Do);
      const long long n = q / Do;
      const T* base = h + (((n * D + 2 * i) * H + 2 * j) * W + 2 * k) * N + cv * V;
      Pack<T, V> in[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        in[t] = load<T, V>(base + (t >> 2) * plane + ((t >> 1) & 1) * line + (t & 1) * N);
      }
      Pack<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float s = to_f32(in[0].v[e]);
#pragma unroll
        for (int t = 1; t < 8; ++t) s = __fadd_rn(s, to_f32(in[t].v[e]));
        s = __fmul_rn(s, 0.125f);
        o.v[e] = from_f32<T>(kBias ? __fadd_rn(s, b[e]) : s);
      }
      store<T, V>(out + r * out_stride + cv * V, o);
    }
  }
}

int grid_for(long long rows, int channels, int vec, int num_sms) {
  const Layout lay(channels, vec);
  const long long want = (rows + static_cast<long long>(lay.by) * kUnroll - 1) /
                         (static_cast<long long>(lay.by) * kUnroll);
  const long long most = static_cast<long long>(num_sms) * kBlocksPerSm;
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

template <typename Tin, typename Tout, int V>
int bn_relu_typed(const void* x, long long rows, int in_stride, int C, const float* mean,
                  const float* var, const float* gamma, const float* beta, float eps,
                  const float* bias, void* y, int num_sms, cudaStream_t st) {
  const int grid = grid_for(rows, C, V, num_sms);
  const size_t smem = sizeof(float) * 3 * C;
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* yo = static_cast<Tout*>(y);
  if (bias) {
    dense_bn_relu<Tin, Tout, V, true><<<grid, kThreads, smem, st>>>(
        xi, rows, in_stride, C, mean, var, gamma, beta, eps, bias, yo);
  } else {
    dense_bn_relu<Tin, Tout, V, false><<<grid, kThreads, smem, st>>>(
        xi, rows, in_stride, C, mean, var, gamma, beta, eps, bias, yo);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int bn_relu_vec(int vec, const void* x, long long rows, int in_stride, int C,
                const float* mean, const float* var, const float* gamma, const float* beta,
                float eps, const float* bias, void* y, int num_sms, cudaStream_t st) {
  constexpr int kWidest = 16 / (sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  switch (vec) {
    case 1:
      return bn_relu_typed<Tin, Tout, 1>(x, rows, in_stride, C, mean, var, gamma, beta, eps,
                                         bias, y, num_sms, st);
    case 2:
      return bn_relu_typed<Tin, Tout, 2>(x, rows, in_stride, C, mean, var, gamma, beta, eps,
                                         bias, y, num_sms, st);
    case 4:
      return bn_relu_typed<Tin, Tout, 4>(x, rows, in_stride, C, mean, var, gamma, beta, eps,
                                         bias, y, num_sms, st);
    case 8:
      if (kWidest >= 8) {
        return bn_relu_typed<Tin, Tout, (kWidest >= 8 ? 8 : 1)>(
            x, rows, in_stride, C, mean, var, gamma, beta, eps, bias, y, num_sms, st);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int V>
int store_typed(bool pool, const void* h, int B, int D, int H, int W, int N,
                const float* bias, void* out, int out_stride, int num_sms, cudaStream_t st) {
  const T* hi = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  if (pool) {
    const long long rows = static_cast<long long>(B) * (D / 2) * (H / 2) * (W / 2);
    const int grid = grid_for(rows, N, V, num_sms);
    if (bias) {
      dense_pool_store<T, V, true><<<grid, kThreads, 0, st>>>(hi, B, D, H, W, N, bias, o,
                                                               out_stride);
    } else {
      dense_pool_store<T, V, false><<<grid, kThreads, 0, st>>>(hi, B, D, H, W, N, bias, o,
                                                                out_stride);
    }
  } else {
    const long long rows = static_cast<long long>(B) * D * H * W;
    const int grid = grid_for(rows, N, V, num_sms);
    if (bias) {
      dense_bias_store<T, V, true><<<grid, kThreads, 0, st>>>(hi, rows, N, bias, o, out_stride);
    } else {
      dense_bias_store<T, V, false><<<grid, kThreads, 0, st>>>(hi, rows, N, bias, o,
                                                                out_stride);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int store_vec(int vec, bool pool, const void* h, int B, int D, int H, int W, int N,
              const float* bias, void* out, int out_stride, int num_sms, cudaStream_t st) {
  constexpr int kWidest = 16 / sizeof(T);
  switch (vec) {
    case 1:
      return store_typed<T, 1>(pool, h, B, D, H, W, N, bias, out, out_stride, num_sms, st);
    case 2:
      return store_typed<T, 2>(pool, h, B, D, H, W, N, bias, out, out_stride, num_sms, st);
    case 4:
      return store_typed<T, 4>(pool, h, B, D, H, W, N, bias, out, out_stride, num_sms, st);
    case 8:
      if (kWidest >= 8) {
        return store_typed<T, (kWidest >= 8 ? 8 : 1)>(pool, h, B, D, H, W, N, bias, out,
                                                      out_stride, num_sms, st);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: rows of in_stride values (kind in_kind), of which the first C are read.
// mean, var, gamma, beta: (C,) float32; bias: (C,) float32 or null. y:
// (rows, C) contiguous, kind out_kind (bfloat16 -> bfloat16, float32 ->
// float32 or bfloat16 -> float32). vec: values a load, dividing C and
// in_stride, with x and y aligned to it. All on the device; launches one
// kernel on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int dense_bn_relu_launch(const void* x, long long rows, int in_stride, int C,
                                    const void* mean, const void* var, const void* gamma,
                                    const void* beta, float eps, const void* bias, void* y,
                                    int in_kind, int out_kind, int vec, int num_sms,
                                    void* stream) {
  if (rows < 1 || C < 1 || C > kMaxChannels || in_stride < C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* m = static_cast<const float*>(mean);
  const auto* v = static_cast<const float*>(var);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* cb = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  if (in_kind == kBFloat16 && out_kind == kBFloat16) {
    return bn_relu_vec<__nv_bfloat16, __nv_bfloat16>(vec, x, rows, in_stride, C, m, v, g, b,
                                                     eps, cb, y, num_sms, st);
  }
  if (in_kind == kFloat32 && out_kind == kFloat32) {
    return bn_relu_vec<float, float>(vec, x, rows, in_stride, C, m, v, g, b, eps, cb, y,
                                     num_sms, st);
  }
  if (in_kind == kBFloat16 && out_kind == kFloat32) {
    return bn_relu_vec<__nv_bfloat16, float>(vec, x, rows, in_stride, C, m, v, g, b, eps, cb,
                                             y, num_sms, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// h: (B, D, H, W, N) contiguous, kind `kind`; bias: (N,) float32 or null.
// out: rows of out_stride values of the same kind, pointing at the first
// channel written: (B, D, H, W) rows, or (B, D/2, H/2, W/2) when pool is
// set. vec divides N and out_stride, with h and out aligned to it. One
// kernel on `stream`; returns cudaGetLastError().
extern "C" int dense_store_launch(int pool, const void* h, int B, int D, int H, int W, int N,
                                  const void* bias, void* out, int out_stride, int kind,
                                  int vec, int num_sms, void* stream) {
  if (B < 1 || N < 1 || out_stride < N || (pool && (D < 2 || H < 2 || W < 2)) ||
      (!pool && (D < 1 || H < 1 || W < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == kBFloat16) {
    return store_vec<__nv_bfloat16>(vec, pool != 0, h, B, D, H, W, N, b, out, out_stride,
                                    num_sms, st);
  }
  if (kind == kFloat32) {
    return store_vec<float>(vec, pool != 0, h, B, D, H, W, N, b, out, out_stride, num_sms, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
