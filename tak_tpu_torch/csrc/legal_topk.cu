// The legal top-K of a search wave, for Hopper (sm_90a): each leaf row's
// K best legal priors and their action ids, read from the row's float32
// policy and the packed legal words that the fused step with legal bits
// (csrc/fused_step_legal.cu) emits for it.
//
// Replaces no TPU kernel: the JAX package leaves the step to XLA
// (`lax.top_k` of `where(legal, policy, -1)`).  Added because the port's
// stage in torch ops builds a dense [R, A] legal mask, a float32 copy of
// the policy and one int64 key an action, then radix-selects over 8-byte
// digits: at 8x8's 8,192 x 65,216 that is some 25 ms of a 130 ms wave.
// The plain PyTorch version (tak_tpu_torch/engine/legal_bits.py:
// masked_topk_packed) states the semantics, and the output is bitwise
// `masked_topk(policy, legal_mask, K, "exact")` of mcts/search.py:
//   * slots in descending order of the prior's float bits, ties to the
//     lower action id (`jax.lax.top_k`);
//   * every legal action beats every illegal one (a legal prior of 0.0
//     included);
//   * with fewer than K legal actions, the pad slots hold -1.0 and the
//     lowest illegal ids, ascending.
// Action ids: c * n^2 + s for the placements (c = flat, wall, cap: bit c of
// place[s]), 3 n^2 + (d * P + p) * n^2 + s for the spreads (bit p % 32 of
// spread[d][p / 32][s]), P = 2^n - 2 patterns.
//
// What bounds it: bytes.  A row reads its policy once (A x 4 B) and its
// words (n^2 + 4 wp n^2 int32) and writes K priors and ids: 37,696 B at
// 6x6 and 269,568 B at 8x8 with K = 32, 0.092 and 0.66 ms for 8,192 rows
// at 3.35 TB/s (benchmark/reference/topk_counts.py).  Design, one block
// of 256 threads a row:
//   * the words go to shared memory, the policy streams through registers
//     in rounds of 2,048 entries (16-byte loads where the row allows them,
//     the next round's loads in flight while this one is filtered), read
//     once from device memory and never written back;
//   * an entry is a candidate when its legal bit is set and its 64-bit key
//     (the prior's order-preserving bits over the inverted id: distinct,
//     and ordered as the output is) is at least the block's threshold;
//     candidates are appended to a shared buffer of one round plus K slots
//     by warp-aggregated offsets.  Illegal entries never enter it: they
//     are only ever needed as pads, whose ids come from the words;
//   * when a round's candidates would overflow the buffer, a radix select
//     (8-bit digits from the top, early exit once a bucket is taken whole)
//     keeps the K best and raises the threshold to the K-th key's selected
//     prefix.  A softmax row rarely holds that many legal actions, so most
//     rows select once, at the end, over their legal entries alone;
//   * the K kept are ranked by counting (two threads an entry) and written
//     to their slots; the pads' ids are the first illegal ids, found with
//     one ballot over ids 0..255 (at least K of them are illegal when
//     fewer than K actions are legal).
// Sizes 3-8 are instances of one template: the shapes' divisions are by
// constants, and the 16-byte path needs an even size (n^2 and A multiples
// of 4) and a 16-byte aligned policy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;                 // policy entries a round
constexpr int ROUND = THREADS * PER_THREAD;
constexpr int KMAX = 128;
constexpr int CAP = ROUND + KMAX;             // candidate slots
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS >= 2 * KMAX, "the ranking and the pads take 2K threads");

template <int N>
struct Shape {
  static constexpr int N2 = N * N;
  static constexpr int P = (1 << N) - 2;
  static constexpr int WP = (P + 31) / 32;
  static constexpr int A = N2 * (3 + 4 * P);
  static constexpr int SPREAD = 4 * WP * N2;  // spread words a row
  static constexpr int WORDS = N2 + SPREAD;
};

template <int VEC> struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<4> { using type = float4; };

// the prior's bits in unsigned order over the inverted id: larger is better
__device__ __forceinline__ unsigned long long make_key(float v, int id) {
  const unsigned b = __float_as_uint(v);
  const unsigned u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~id);
}

__device__ __forceinline__ float key_val(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return (int)~(unsigned)key;
}

// the legal bit of action `id` in the row's words (place, then spread)
template <int N>
__device__ __forceinline__ bool legal_bit(const int* words, int id) {
  using S = Shape<N>;
  if (id < 3 * S::N2) {
    const int c = id / S::N2, s = id - c * S::N2;
    return (words[s] >> c) & 1;
  }
  const int b = id - 3 * S::N2;
  const int dp = b / S::N2, s = b - dp * S::N2;
  const int d = dp / S::P, p = dp - d * S::P;
  return (words[S::N2 + (d * S::WP + (p >> 5)) * S::N2 + s] >> (p & 31)) & 1;
}

// the legal bits of actions e0..e0+3 (e0 % 4 == 0, n^2 % 4 == 0: one word
// group of four squares), bit q for action e0 + q
template <int N>
__device__ __forceinline__ unsigned legal_bits4(const int* words, int e0) {
  using S = Shape<N>;
  int word, shift;
  if (e0 < 3 * S::N2) {
    const int c = e0 / S::N2;
    word = e0 - c * S::N2;
    shift = c;
  } else {
    const int b = e0 - 3 * S::N2;
    const int dp = b / S::N2, s = b - dp * S::N2;
    const int d = dp / S::P, p = dp - d * S::P;
    word = S::N2 + (d * S::WP + (p >> 5)) * S::N2 + s;
    shift = p & 31;
  }
  const int4 w = *reinterpret_cast<const int4*>(words + word);
  return ((w.x >> shift) & 1) | (((w.y >> shift) & 1) << 1)
         | (((w.z >> shift) & 1) << 2) | (((w.w >> shift) & 1) << 3);
}

template <int N, int VEC>
__device__ __forceinline__ void load_round(
    const float* __restrict__ row, int r,
    typename Vec<VEC>::type (&v)[PER_THREAD / VEC]) {
  using V = typename Vec<VEC>::type;
  const V* p = reinterpret_cast<const V*>(row);
#pragma unroll
  for (int j = 0; j < PER_THREAD / VEC; ++j) {
    const int e0 = r * ROUND + (j * THREADS + (int)threadIdx.x) * VEC;
    if (e0 < Shape<N>::A) v[j] = __ldcs(p + e0 / VEC);
  }
}

__device__ __forceinline__ float lane_of(const float& v, int) { return v; }
__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

struct Smem {
  unsigned long long buf[CAP];
  unsigned long long sel[KMAX];
  unsigned hist[256];
  int warp_n[THREADS / 32];
  unsigned long long thresh;
  int cnt, pending[2], nsel, digit, above, bucket;
};

// The K best of buf[0, cnt) (cnt > k), by a radix select over the keys'
// bytes from the top: on return every thread holds (prefix, mask), and
// the selected keys are exactly those with (key & mask) >= prefix.
__device__ void radix_select(Smem& sm, int cnt, int k,
                             unsigned long long& prefix_out,
                             unsigned long long& mask_out) {
  const int t = threadIdx.x, lane = t & 31;
  unsigned long long prefix = 0, mask = 0;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += THREADS) sm.hist[i] = 0;
    __syncthreads();
    for (int i = t; i < cnt; i += THREADS) {
      const unsigned long long x = sm.buf[i];
      if ((x & mask) == prefix)
        atomicAdd(&sm.hist[(unsigned)(x >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (t < 32) {   // lane l: bins 255 - 8l - j, j = 0..7, from the top
      unsigned h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = sm.hist[255 - 8 * lane - j];
        sum += h[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      unsigned acc = incl - sum;
      if (acc < (unsigned)need && (unsigned)need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc < (unsigned)need && (unsigned)need <= acc + h[j]) {
            sm.digit = 255 - 8 * lane - j;
            sm.above = (int)acc;
            sm.bucket = (int)h[j];
          }
          acc += h[j];
        }
      }
    }
    __syncthreads();
    need -= sm.above;
    prefix |= (unsigned long long)sm.digit << shift;
    mask |= 0xffull << shift;
    if (sm.bucket == need) break;   // the whole bucket is in
  }
  prefix_out = prefix;
  mask_out = mask;
}

// The selected K of buf[0, cnt) into sel[0, k), in no order.
__device__ void gather_selected(Smem& sm, int cnt, int k,
                                unsigned long long& prefix) {
  unsigned long long mask;
  if (threadIdx.x == 0) sm.nsel = 0;
  radix_select(sm, cnt, k, prefix, mask);   // syncs after the reset
  for (int i = threadIdx.x; i < cnt; i += THREADS) {
    const unsigned long long x = sm.buf[i];
    if ((x & mask) >= prefix) sm.sel[atomicAdd(&sm.nsel, 1)] = x;
  }
  __syncthreads();
}

template <int N, int VEC>
__global__ void __launch_bounds__(THREADS, 4) tak_legal_topk_kernel(
    const float* __restrict__ policy, const int* __restrict__ place,
    const int* __restrict__ spread, float* __restrict__ vals,
    int* __restrict__ ids, int K) {
  using S = Shape<N>;
  using V = typename Vec<VEC>::type;
  constexpr int NV = PER_THREAD / VEC;
  constexpr int ROUNDS = (S::A + ROUND - 1) / ROUND;
  __shared__ __align__(16) int words[S::WORDS];
  __shared__ Smem sm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row = blockIdx.x;
  const float* pr = policy + row * S::A;

  V cur[NV], nxt[NV];
  load_round<N, VEC>(pr, 0, cur);
  for (int i = t; i < S::N2; i += THREADS) words[i] = place[row * S::N2 + i];
  for (int i = t; i < S::SPREAD; i += THREADS)
    words[S::N2 + i] = spread[row * S::SPREAD + i];
  if (t == 0) {
    sm.cnt = 0;
    sm.pending[0] = sm.pending[1] = 0;
    sm.thresh = 0;
  }
  __syncthreads();

  for (int r = 0; r < ROUNDS; ++r) {
    if (r + 1 < ROUNDS) load_round<N, VEC>(pr, r + 1, nxt);
    const unsigned long long thresh = sm.thresh;
    unsigned take = 0;    // bit j * VEC + q: entry q of vector j is in
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = r * ROUND + (j * THREADS + t) * VEC;
      if (e0 < S::A) {
        unsigned legal;
        if constexpr (VEC == 4) legal = legal_bits4<N>(words, e0);
        else legal = legal_bit<N>(words, e0);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          if (((legal >> q) & 1)
              && make_key(lane_of(cur[j], q), e0 + q) >= thresh)
            take |= 1u << (j * VEC + q);
      }
    }
    const int n = __popc(take);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int wtot = __shfl_sync(FULL, incl, 31);
    int wbase = 0;
    if (lane == 31 && wtot) wbase = atomicAdd(&sm.pending[r & 1], wtot);
    wbase = __shfl_sync(FULL, wbase, 31);
    __syncthreads();
    const int pending = sm.pending[r & 1];
    int cnt = sm.cnt;
    if (cnt + pending > CAP) {   // keep the K best, raise the threshold
      unsigned long long prefix;
      gather_selected(sm, cnt, K, prefix);
      for (int i = t; i < K; i += THREADS) sm.buf[i] = sm.sel[i];
      if (t == 0) sm.thresh = prefix;
      __syncthreads();
      cnt = K;
    }
    int pos = cnt + wbase + incl - n;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if ((take >> (j * VEC + q)) & 1)
          sm.buf[pos++] = make_key(lane_of(cur[j], q),
                                   r * ROUND + (j * THREADS + t) * VEC + q);
    __syncthreads();
    if (t == 0) {
      sm.cnt = cnt + pending;
      sm.pending[r & 1] = 0;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
  __syncthreads();

  const int cnt = sm.cnt;
  const unsigned long long* best = sm.buf;
  if (cnt > K) {
    unsigned long long prefix;
    gather_selected(sm, cnt, K, prefix);
    best = sm.sel;
  }
  const int kk = cnt < K ? cnt : K;
  {  // rank by counting: thread pair (2i, 2i+1) counts the keys above key i
    const int i = t >> 1, h = t & 1;
    int above = 0;
    unsigned long long x = 0;
    if (i < kk) {
      x = best[i];
      const int half = (kk + 1) >> 1;
      const int j1 = h ? kk : half;
      for (int j = h ? half : 0; j < j1; ++j) above += best[j] > x;
    }
    above += __shfl_xor_sync(FULL, above, 1);
    if (i < kk && h == 0) {
      vals[row * K + above] = key_val(x);
      ids[row * K + above] = key_id(x);
    }
  }
  if (cnt < K) {   // pads: the lowest illegal ids, ascending, prior -1
    const bool illegal = t < S::A && !legal_bit<N>(words, t);
    const unsigned ball = __ballot_sync(FULL, illegal);
    if (lane == 0) sm.warp_n[warp] = __popc(ball);
    __syncthreads();
    int pos = __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) pos += sm.warp_n[w];
    if (illegal && pos < K - cnt) {
      vals[row * K + cnt + pos] = -1.0f;
      ids[row * K + cnt + pos] = t;
    }
  }
}

template <int N, int VEC>
cudaError_t launch(int rows, int k, const void* policy, const void* place,
                   const void* spread, void* vals, void* ids,
                   cudaStream_t stream) {
  tak_legal_topk_kernel<N, VEC><<<rows, THREADS, 0, stream>>>(
      (const float*)policy, (const int*)place, (const int*)spread,
      (float*)vals, (int*)ids, k);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_size(bool vec, int rows, int k, const void* policy,
                        const void* place, const void* spread, void* vals,
                        void* ids, cudaStream_t stream) {
  if constexpr (N % 2 == 0) {
    if (vec)
      return launch<N, 4>(rows, k, policy, place, spread, vals, ids, stream);
  }
  return launch<N, 1>(rows, k, policy, place, spread, vals, ids, stream);
}

int actions(int n) { return n * n * (3 + 4 * ((1 << n) - 2)); }

}  // namespace

// n, rows, A, K, policy [rows, A] float32, place [rows, n^2] int32,
// spread [rows, 4, wp, n^2] int32, vals [rows, K] float32, ids [rows, K]
// int32, stream; every array contiguous.  n 3-8, 1 <= K <= min(128, A).
extern "C" int tak_legal_topk(int n, int rows, int A, int k,
                              const void* policy, const void* place,
                              const void* spread, void* vals, void* ids,
                              void* stream) {
  if (n < 3 || n > 8 || rows < 0 || A != actions(n) || k < 1 || k > KMAX
      || k > A)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const bool vec = ((uintptr_t)policy & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (n) {
    case 3: err = launch_size<3>(vec, rows, k, policy, place, spread, vals, ids, s); break;
    case 4: err = launch_size<4>(vec, rows, k, policy, place, spread, vals, ids, s); break;
    case 5: err = launch_size<5>(vec, rows, k, policy, place, spread, vals, ids, s); break;
    case 6: err = launch_size<6>(vec, rows, k, policy, place, spread, vals, ids, s); break;
    case 7: err = launch_size<7>(vec, rows, k, policy, place, spread, vals, ids, s); break;
    default: err = launch_size<8>(vec, rows, k, policy, place, spread, vals, ids, s); break;
  }
  return (int)err;
}
