// The legal sampler and the whole env rollout for Hopper (sm_90a).
//
// Replaces tak_tpu/engine/pallas_env.py:927 build_legal_sampler and :990
// build_env_rollout.  The plain PyTorch versions are engine/env_rollout.py
// legal_sampler_plain and env_rollout_plain; both kernels must agree with
// them bit for bit, with external bits and with a seed.
//
//   tak_legal_sampler: per row, the packed legal bits of the state, then one
//     uniform legal action (r = bits % max(total, 1), unsigned, over the
//     reference's group order) and the legal count.  One thread per row, 64
//     threads per block (the thread-per-row code of env_common.cuh).
//   tak_env_rollout: per row, T times (legal classes -> sample -> step ->
//     result -> freeze rows that were finished on entry -> reset rows
//     finished now to the start position, komi kept), the state held in
//     registers for the whole rollout: ONE launch, one read and one write of
//     the state.  One warp per row, a square per lane (env_warp.cuh): the
//     legal classes come from blocker and wall bitboards made by ballots,
//     the sample from per-group warp sums and a warp scan, the step and the
//     result as in fused_step.cu.
//
// Random bits: either given ([R] / [T, R] int64 carrying u32 values) or
// Philox4x32-10 with key = seed and counter = (row, step), written out here
// so that the plain version computes the same words; every lane of a row's
// warp runs the generator (registers only, no shuffle).
//
// What bounds the rollout: operations (T steps of integer, branchy work per
// row against 1.8 KB moved).  A warp per row turns each step's serial walks
// over the squares into a few dozen warp-wide instructions, and 8,192 rows
// are 1,024 blocks of 8 warps: enough warps on every SM to hide the latency
// of the shuffles and ballots of each one's chain.

#include "env_warp.cuh"

template <int N, int W>
__global__ void legal_sampler_kernel(StateIn in, const int* tables,
                                     const long long* bits, int use_seed,
                                     uint32_t k0, uint32_t k1, int* action,
                                     int* total, int rows) {
  __shared__ uint32_t tab[LegalDims<N>::TABLE_WORDS];
  stage_tables<N>(tables, tab);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Row<N, W> s;
  load_row<N, W>(in, r, s);
  LegalRow<N> g;
  legal_prepare<N, W>(s, g);
  const uint32_t word = use_seed ? philox_bits(k0, k1, (uint32_t)r, 0u)
                                 : (uint32_t)bits[r];
  int a, tot;
  sample_action<N>(g, tab, word, a, tot);
  action[r] = a;
  total[r] = tot;
}

template <int N, int W>
__global__ void env_rollout_kernel(StateIn in, StateOut out, const int* tables,
                                   const long long* bits, int use_seed,
                                   uint32_t k0, uint32_t k1, int steps,
                                   int start_stones, int start_caps,
                                   int rows) {
  __shared__ uint32_t tab[LegalDims<N>::TABLE_WORDS];
  __shared__ uint32_t ctab[CountDims<N>::WORDS];
  stage_tables<N>(tables, tab);
  stage_counts<N>(tab, ctab);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;                     // the whole warp: r is its row
  WarpGame<N, W> g;
  warp_load<N, W>(in, r, lane, g);
  uint32_t words = 0u;   // lane l: the random word of step (t & ~31) + l
  for (int t = 0; t < steps; ++t) {
    if ((t & 31) == 0) {
      const int tl = t + lane;
      if (use_seed)
        words = philox_bits(k0, k1, (uint32_t)r, (uint32_t)tl);
      else if (tl < steps)
        words = (uint32_t)bits[(size_t)tl * rows + r];
    }
    if (g.result == ONGOING) {     // a row finished on entry stays frozen
      WarpLegal<WarpGame<N, W>::S> legal;
      warp_legal<N, W>(g, lane, legal);
      const uint32_t word = __shfl_sync(FULL_WARP, words, t & 31);
      int a, tot;
      warp_sample<N, WarpGame<N, W>::S>(legal, tab, ctab, word, lane, a,
                                        tot);
      warp_step<N, W>(g, a, lane);
      g.result = warp_result<N, W>(g, lane);
    }
    if (g.result != ONGOING) warp_reset<N, W>(g, start_stones, start_caps);
  }
  warp_store<N, W>(out, r, lane, g);
}

extern "C" int tak_legal_sampler(
    int n, int rows,
    void* i0, void* i1, void* i2, void* i3, void* i4, void* i5, void* i6,
    void* i7, void* i8, void* i9,
    void* tables, void* bits, int use_seed, unsigned int k0, unsigned int k1,
    void* action, void* total, void* stream) {
  void* ins[10] = {i0, i1, i2, i3, i4, i5, i6, i7, i8, i9};
  const StateIn in = state_in(ins);
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 64;
  const int blocks = (rows + threads - 1) / threads;
#define CALL(N_, W_)                                                      \
  legal_sampler_kernel<N_, W_><<<blocks, threads, 0, s>>>(                \
      in, (const int*)tables, (const long long*)bits, use_seed, k0, k1,   \
      (int*)action, (int*)total, rows)
  TAK_DISPATCH_SIZE(n, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int tak_env_rollout(
    int n, int rows, int steps, int start_stones, int start_caps,
    void* i0, void* i1, void* i2, void* i3, void* i4, void* i5, void* i6,
    void* i7, void* i8, void* i9,
    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5, void* o6,
    void* o7, void* o8, void* o9,
    void* tables, void* bits, int use_seed, unsigned int k0, unsigned int k1,
    void* stream) {
  void* ins[10] = {i0, i1, i2, i3, i4, i5, i6, i7, i8, i9};
  void* outs[10] = {o0, o1, o2, o3, o4, o5, o6, o7, o8, o9};
  const StateIn in = state_in(ins);
  const StateOut out = state_out(outs);
  cudaStream_t s = (cudaStream_t)stream;
  const int warps = warps_per_block(rows);
  const int blocks = (rows + warps - 1) / warps;
#define CALL(N_, W_)                                                      \
  env_rollout_kernel<N_, W_><<<blocks, 32 * warps, 0, s>>>(               \
      in, out, (const int*)tables, (const long long*)bits, use_seed, k0,  \
      k1, steps, start_stones, start_caps, rows)
  TAK_DISPATCH_SIZE(n, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
