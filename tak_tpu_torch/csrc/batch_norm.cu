// Train-mode BatchNorm for Hopper (sm_90a): the batch statistics and the
// normalisation forward, the two reductions and the input gradient backward.
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.BatchNorm to XLA.
// Added because BatchNorm's float32 passes through PyTorch's generic
// elementwise and reduction kernels held 61% of the learner's device time
// (Net6, 20 chunks of 4,000 rows a step).  The plain PyTorch version
// (tak_tpu_torch/model/batch_norm.py: BatchNormPlain) states the semantics,
// flax's arithmetic: var = max(E[x^2] - E[x]^2, 0), y = (x - mean) *
// (rsqrt(var + eps) * weight) + bias, all in float32 (float64 for float64
// input), stored in the input's type.
//
// Layout: x, y, dy and dx are channels-last tensors read as [rows, C]
// (rows = N*H*W), in bf16, float32 or float64; C is a multiple of 8 and at
// most 2,048.  Each thread owns 8 neighbouring channels of a row (one
// 16-byte load in bf16) and keeps that channel group in every row it
// visits, so its per-channel constants stay in registers.  weight, bias and
// the running statistics are float32 [C].
//
// What bounds it: bytes.  At the learner's shape (144,000 rows x 128
// channels, bf16, 36.9 MB) a forward needs 3 passes over x (read for the
// sums, read again and write y) and a backward 5 (read x and dy for the
// sums, read both again and write dx), 33 and 55 us at 3.35 TB/s.  Each
// pass is one launch that moves each of those bytes once:
//   * tak_bn_stats / tak_bn_grad_sums: about 2 blocks an SM, each walking
//     its own slab of rows with four 16-byte loads in flight a thread and
//     float32 sums in registers, combined across the block in shared memory
//     into partials [G, 2, C];
//   * tak_bn_finalize: one block sums the G partials in a fixed order (no
//     atomics: every run gives the same bits), then the statistics, the
//     normalisation's per-channel constants and the running statistics;
//   * tak_bn_normalize / tak_bn_grad_input: elementwise, 6 blocks of 256
//     threads an SM, each walking its slab of rows four and two rows at a
//     time (four 16-byte loads in flight), its constants formed once.
// Saved for the backward: x as it came in and [4, C] constants (mean,
// 1/std, 1/std * weight, and 1 where the variance was not clipped at 0), no
// float32 copy of x and no x-hat.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;        // a block: 512 / (C / 8) rows a step
constexpr int ELEM_THREADS = 256;   // tak_bn_normalize, tak_bn_grad_input
constexpr int ELEM_BLOCKS_PER_SM = 6;
constexpr int FINAL_THREADS = 1024;
// rows a thread takes at once: four 16-byte loads in flight in each pass
constexpr int STATS_ROWS = 4;       // tak_bn_stats, tak_bn_normalize
constexpr int GRAD_ROWS = 2;        // tak_bn_grad_sums, tak_bn_grad_input
constexpr double EPS = 1e-5;        // flax's default
constexpr float MOMENTUM = 0.99f;   // running = 0.99 running + 0.01 batch

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// 8 neighbouring channels of one row, widened to the arithmetic's type
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, double v[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p) + i);
    v[2 * i] = d.x;
    v[2 * i + 1] = d.y;
  }
}

// rounded to the nearest, ties to even, as torch's .to(bfloat16)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(double* p, const double v[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
}

__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

template <typename A>
__device__ __forceinline__ void load_consts(const A* src, int c0, A v[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = src[c0 + j];
}

// This thread's channel group (lane) and row within a step (sub); a block
// is rps rows of C / 8 threads.
struct RowThread {
  int lane, sub, rps, c0;
  __device__ RowThread(int C) {
    const int lanes = C / 8;
    lane = threadIdx.x % lanes;
    sub = threadIdx.x / lanes;
    rps = blockDim.x / lanes;
    c0 = lane * 8;
  }
};

// Block b's slab of rows: per channel, forward the sums of x and x^2,
// backward the sums of dy and dy * x-hat; combined over the block's rows in
// a fixed order into partials [b, 0..1, C].
template <typename T, bool GRAD>
__device__ __forceinline__ void slab_sums(
    const T* __restrict__ x, const T* __restrict__ dy,
    const typename AccOf<T>::type* __restrict__ stats,
    typename AccOf<T>::type* __restrict__ partials, long long rows, int C) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);            // [rps][C]
  const RowThread t(C);
  const long long start = rows * blockIdx.x / gridDim.x;
  const long long end = rows * (blockIdx.x + 1) / gridDim.x;
  A s0[8], s1[8], mean[8], inv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s0[j] = s1[j] = A(0);
  if constexpr (GRAD) {
    load_consts(stats, t.c0, mean);
    load_consts(stats + C, t.c0, inv);
  }
  auto add = [&](const A v[8], const A g[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (GRAD) {
        const A xh = (v[j] - mean[j]) * inv[j];
        s0[j] += g[j];
        s1[j] += g[j] * xh;
      } else {
        s0[j] += v[j];
        s1[j] += v[j] * v[j];
      }
    }
  };
  constexpr int ahead = GRAD ? GRAD_ROWS : STATS_ROWS;
  const long long step = t.rps;
  long long r = start + t.sub;
  for (; r + (ahead - 1) * step < end; r += ahead * step) {
    A v[ahead][8], g[ahead][8];
#pragma unroll
    for (int k = 0; k < ahead; ++k) {
      load8(x + (r + k * step) * C + t.c0, v[k]);
      if constexpr (GRAD) load8(dy + (r + k * step) * C + t.c0, g[k]);
    }
#pragma unroll
    for (int k = 0; k < ahead; ++k) add(v[k], g[k]);
  }
  for (; r < end; r += step) {
    A v[8], g[8];
    load8(x + r * C + t.c0, v);
    if constexpr (GRAD) load8(dy + r * C + t.c0, g);
    add(v, g);
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sh[t.sub * C + t.c0 + j] = pass ? s1[j] : s0[j];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      A total = A(0);
      for (int k = 0; k < t.rps; ++k) total += sh[k * C + c];
      partials[((long long)blockIdx.x * 2 + pass) * C + c] = total;
    }
    __syncthreads();
  }
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(THREADS) tak_bn_stats_kernel(
    const T* __restrict__ x, typename AccOf<T>::type* __restrict__ partials,
    long long rows, int C) {
  slab_sums<T, false>(x, nullptr, nullptr, partials, rows, C);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) tak_bn_grad_sums_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const typename AccOf<T>::type* __restrict__ stats,
    typename AccOf<T>::type* __restrict__ partials, long long rows, int C) {
  slab_sums<T, true>(x, dy, stats, partials, rows, C);
}

// One block.  With partials: sums[k, c] = (sum over g of partials[g, k, c])
// / divisor, each channel's G partials split over P threads in a fixed
// order.  With stats: from sums = [E[x], E[x^2]], the constants [mean,
// 1/std, 1/std * weight, keep] and the running statistics' move.
template <typename A>
__global__ void __launch_bounds__(FINAL_THREADS) tak_bn_finalize_kernel(
    const A* __restrict__ partials, int G, int C, A divisor,
    A* __restrict__ sums, const float* __restrict__ weight,
    float* __restrict__ running_mean, float* __restrict__ running_var,
    A* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);            // [P][2][per]
  if (partials != nullptr) {
    const int per = C < (int)blockDim.x ? C : (int)blockDim.x;
    const int P = blockDim.x / per;
    const int i = threadIdx.x % per;
    const int part = threadIdx.x / per;
    for (int c0 = 0; c0 < C; c0 += per) {
      const int c = c0 + i;
      if (part < P) {
        A t0 = A(0), t1 = A(0);
        if (c < C) {
          // sequential sums, their loads issued eight ahead
#pragma unroll 8
          for (int g = part; g < G; g += P) {
            t0 += partials[(long long)(2 * g) * C + c];
            t1 += partials[(long long)(2 * g + 1) * C + c];
          }
        }
        sh[(2 * part) * per + i] = t0;
        sh[(2 * part + 1) * per + i] = t1;
      }
      __syncthreads();
      if (part == 0 && c < C) {
        A u0 = A(0), u1 = A(0);
        for (int k = 0; k < P; ++k) {
          u0 += sh[(2 * k) * per + i];
          u1 += sh[(2 * k + 1) * per + i];
        }
        sums[c] = u0 / divisor;
        sums[C + c] = u1 / divisor;
      }
      __syncthreads();
    }
  }
  if (stats == nullptr) return;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const A mean = sums[c];
    const A gap = sums[C + c] - mean * mean;
    const A var = gap < A(0) ? A(0) : gap;
    const A inv = A(1) / root(var + A(EPS));
    stats[c] = mean;
    stats[C + c] = inv;
    stats[2 * C + c] = inv * A(weight[c]);
    // autograd's clamp passes the gradient where gap >= 0
    stats[3 * C + c] = gap >= A(0) ? A(1) : A(0);
    const A rate = A(1.0 - 0.99);
    running_mean[c] = float(A(running_mean[c] * MOMENTUM) + rate * mean);
    running_var[c] = float(A(running_var[c] * MOMENTUM) + rate * var);
  }
}

// Block b's slab of rows, as in slab_sums: the per-channel constants are
// formed once a thread and serve its every row.

// y = (x - mean) * (1/std * weight) + bias
template <typename T>
__global__ void __launch_bounds__(ELEM_THREADS) tak_bn_normalize_kernel(
    const T* __restrict__ x, const typename AccOf<T>::type* __restrict__ stats,
    const float* __restrict__ bias, T* __restrict__ y, long long rows, int C) {
  using A = typename AccOf<T>::type;
  const RowThread t(C);
  A mean[8], mul[8], b[8];
  load_consts(stats, t.c0, mean);
  load_consts(stats + 2 * C, t.c0, mul);
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = A(bias[t.c0 + j]);
  auto one = [&](A v[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] - mean[j]) * mul[j] + b[j];
  };
  const long long start = rows * blockIdx.x / gridDim.x;
  const long long end = rows * (blockIdx.x + 1) / gridDim.x;
  const long long step = t.rps;
  long long r = start + t.sub;
  for (; r + (STATS_ROWS - 1) * step < end; r += STATS_ROWS * step) {
    A v[STATS_ROWS][8];
#pragma unroll
    for (int k = 0; k < STATS_ROWS; ++k)
      load8(x + (r + k * step) * C + t.c0, v[k]);
#pragma unroll
    for (int k = 0; k < STATS_ROWS; ++k) {
      one(v[k]);
      store8(y + (r + k * step) * C + t.c0, v[k]);
    }
  }
  for (; r < end; r += step) {
    A v[8];
    load8(x + r * C + t.c0, v);
    one(v);
    store8(y + r * C + t.c0, v);
  }
}

// dx = (dy - sum(dy) / n - x-hat * (sum(dy * x-hat) / n) * keep)
//      * (weight * 1/std), with x-hat = (x - mean) * 1/std
template <typename T>
__global__ void __launch_bounds__(ELEM_THREADS) tak_bn_grad_input_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const typename AccOf<T>::type* __restrict__ stats,
    const typename AccOf<T>::type* __restrict__ sums,
    const float* __restrict__ weight, typename AccOf<T>::type count,
    T* __restrict__ dx, long long rows, int C) {
  using A = typename AccOf<T>::type;
  const RowThread t(C);
  A mean[8], inv[8], mdy[8], mdyx[8], a[8];
  load_consts(stats, t.c0, mean);
  load_consts(stats + C, t.c0, inv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = t.c0 + j;
    mdy[j] = sums[c] / count;
    mdyx[j] = sums[C + c] / count * stats[3 * C + c];
    a[j] = A(weight[c]) * inv[j];
  }
  auto one = [&](A v[8], const A g[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const A xh = (v[j] - mean[j]) * inv[j];
      v[j] = (g[j] - mdy[j] - xh * mdyx[j]) * a[j];
    }
  };
  const long long start = rows * blockIdx.x / gridDim.x;
  const long long end = rows * (blockIdx.x + 1) / gridDim.x;
  const long long step = t.rps;
  long long r = start + t.sub;
  for (; r + (GRAD_ROWS - 1) * step < end; r += GRAD_ROWS * step) {
    A v[GRAD_ROWS][8], g[GRAD_ROWS][8];
#pragma unroll
    for (int k = 0; k < GRAD_ROWS; ++k) {
      load8(x + (r + k * step) * C + t.c0, v[k]);
      load8(dy + (r + k * step) * C + t.c0, g[k]);
    }
#pragma unroll
    for (int k = 0; k < GRAD_ROWS; ++k) {
      one(v[k], g[k]);
      store8(dx + (r + k * step) * C + t.c0, v[k]);
    }
  }
  for (; r < end; r += step) {
    A v[8], g[8];
    load8(x + r * C + t.c0, v);
    load8(dy + r * C + t.c0, g);
    one(v, g);
    store8(dx + r * C + t.c0, v);
  }
}

namespace {

enum Kind { BF16 = 0, F32 = 1, F64 = 2 };

int row_threads(int C, int threads) {
  return (threads / (C / 8)) * (C / 8);
}

// the elementwise passes' blocks: ELEM_BLOCKS_PER_SM an SM, none idle
int elem_blocks(long long rows, int C, int sms) {
  const long long rps = ELEM_THREADS / (C / 8);
  const long long most = (rows + rps - 1) / rps;
  const long long want = (long long)ELEM_BLOCKS_PER_SM * sms;
  return (int)(want < most ? want : most);
}

bool bad_shape(long long rows, int C) {
  return rows <= 0 || C <= 0 || C % 8 != 0 || C / 8 > ELEM_THREADS;
}

}  // namespace

// T: the tensors' type, A: the arithmetic's
#define TAK_BN_DISPATCH(kind, ...)                                   \
  switch (kind) {                                                    \
    case BF16: {                                                     \
      using T = __nv_bfloat16; using A = float; __VA_ARGS__; break;  \
    }                                                                \
    case F32: { using T = float; using A = float; __VA_ARGS__; break; } \
    case F64: {                                                      \
      using T = double; using A = double; __VA_ARGS__; break;        \
    }                                                                \
    default: return (int)cudaErrorInvalidValue;                      \
  }

// kind, rows, C, G, x, partials [G, 2, C], stream
extern "C" int tak_bn_stats(int kind, long long rows, int C, int G,
                            const void* x, void* partials, void* stream) {
  if (bad_shape(rows, C) || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TAK_BN_DISPATCH(kind, tak_bn_stats_kernel<T>
      <<<G, row_threads(C, THREADS), row_threads(C, THREADS) * 8 * sizeof(A),
         s>>>((const T*)x, (A*)partials, rows, C))
  return (int)cudaGetLastError();
}

// kind, rows, C, G, x, dy, stats [4, C], partials [G, 2, C], stream
extern "C" int tak_bn_grad_sums(int kind, long long rows, int C, int G,
                                const void* x, const void* dy,
                                const void* stats, void* partials,
                                void* stream) {
  if (bad_shape(rows, C) || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TAK_BN_DISPATCH(kind, tak_bn_grad_sums_kernel<T>
      <<<G, row_threads(C, THREADS), row_threads(C, THREADS) * 8 * sizeof(A),
         s>>>((const T*)x, (const T*)dy, (const A*)stats, (A*)partials, rows,
              C))
  return (int)cudaGetLastError();
}

// kind, C, G, divisor, partials (or null), sums [2, C], weight,
// running_mean, running_var, stats [4, C] (or null), stream
extern "C" int tak_bn_finalize(int kind, int C, int G, double divisor,
                               const void* partials, void* sums,
                               const void* weight, void* running_mean,
                               void* running_var, void* stats, void* stream) {
  if (C <= 0 || (partials != nullptr && G <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = C < FINAL_THREADS ? C : FINAL_THREADS;
  TAK_BN_DISPATCH(kind, tak_bn_finalize_kernel<A>
      <<<1, FINAL_THREADS, (FINAL_THREADS / per) * 2 * per * sizeof(A), s>>>(
          (const A*)partials, G, C, (A)divisor, (A*)sums,
          (const float*)weight, (float*)running_mean, (float*)running_var,
          (A*)stats))
  return (int)cudaGetLastError();
}

// kind, rows, C, the card's SM count, x, stats [4, C], bias, y, stream
extern "C" int tak_bn_normalize(int kind, long long rows, int C, int sms,
                                const void* x, const void* stats,
                                const void* bias, void* y, void* stream) {
  if (bad_shape(rows, C) || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TAK_BN_DISPATCH(kind, tak_bn_normalize_kernel<T>
      <<<elem_blocks(rows, C, sms), row_threads(C, ELEM_THREADS), 0, s>>>(
          (const T*)x, (const A*)stats, (const float*)bias, (T*)y, rows, C))
  return (int)cudaGetLastError();
}

// kind, rows, C, the card's SM count, count (rows over every rank), x,
// dy, stats [4, C], sums [2, C] (over every rank), weight, dx, stream
extern "C" int tak_bn_grad_input(int kind, long long rows, int C, int sms,
                                 double count, const void* x, const void* dy,
                                 const void* stats, const void* sums,
                                 const void* weight, void* dx, void* stream) {
  if (bad_shape(rows, C) || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TAK_BN_DISPATCH(kind, tak_bn_grad_input_kernel<T>
      <<<elem_blocks(rows, C, sms), row_threads(C, ELEM_THREADS), 0, s>>>(
          (const T*)x, (const T*)dy, (const A*)stats, (const A*)sums,
          (const float*)weight, (A)count, (T*)dx, rows, C))
  return (int)cudaGetLastError();
}
