// What the env kernels share (fused_step.cu, fused_step_legal.cu and
// env_rollout.cu, all a warp per game on the device code of env_warp.cuh):
//
//   StateIn/StateOut   the GameState fields in their batch-first layout
//   LegalDims<N>       the pattern class tables' dimensions; stage_tables
//                      copies them into a block's shared memory
//   philox_bits        Philox4x32-10, key = seed, counter = (row, step)
//   TAK_DISPATCH_SIZE  sizes 3-8 with their stack words
//
// Semantics are those of the plain PyTorch versions (engine/fused_env.py
// step_plain, engine/legal_bits.py legal_bits_plain and step_legal_plain,
// engine/env_rollout.py legal_sampler_plain / sample_action_plain /
// philox_bits_plain); the kernels must agree with them bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY 0
#define FLAT 1
#define WALL 2
#define CAP 3
#define ONGOING 0
#define WHITE_ROAD 1
#define BLACK_ROAD 2
#define WHITE_FLATS 3
#define BLACK_FLATS 4
#define DRAW_FLATS 5
#define DRAW_REVERSIBLE 6
#define REVERSIBLE_PLIES 50

struct StateIn {
  const long long* stacks; const int* heights; const int* tops;
  const int* to_move; const int* ply; const int* stones; const int* caps;
  const int* half_komi; const int* reversible; const int* result;
};
struct StateOut {
  long long* stacks; int* heights; int* tops; int* to_move; int* ply;
  int* stones; int* caps; int* half_komi; int* reversible; int* result;
};

static inline StateIn state_in(void* const* p) {
  return {(const long long*)p[0], (const int*)p[1], (const int*)p[2],
          (const int*)p[3], (const int*)p[4], (const int*)p[5],
          (const int*)p[6], (const int*)p[7], (const int*)p[8],
          (const int*)p[9]};
}
static inline StateOut state_out(void* const* p) {
  return {(long long*)p[0], (int*)p[1], (int*)p[2], (int*)p[3], (int*)p[4],
          (int*)p[5], (int*)p[6], (int*)p[7], (int*)p[8], (int*)p[9]};
}

__device__ __forceinline__ int trunc_div2(int x) {
  return x >= 0 ? x / 2 : -((-x) / 2);
}

// ---------------------------------------------------------------------------
// Packed legal bits.
//
// The pattern class tables (engine/legal_bits.py pattern_class_tables) come
// from the host as one int32 array of (3N + 1) rows of WP words, in the order
// KMASK[0..N], SMASK[0..N-1], SMASHM[0..N-1]; each block stages them in shared
// memory.  The spread word (q, d, w) of a square the mover owns is
//   KMASK[min(height, N)][w] & (SMASK[c][w] | (smash ? SMASHM[c][w] : 0))
// with c the leading passable squares along the ray and smash set when the
// first blocker is an on-board wall and the origin's top is a capstone.
// ---------------------------------------------------------------------------

template <int N>
struct LegalDims {
  static constexpr int N2 = N * N;
  static constexpr int P = (1 << N) - 2;
  static constexpr int WP = (P + 31) / 32;
  static constexpr int TABLE_WORDS = (3 * N + 1) * WP;
};

template <int N>
__device__ __forceinline__ void stage_tables(const int* tables,
                                             uint32_t* shared) {
  for (int i = threadIdx.x; i < LegalDims<N>::TABLE_WORDS; i += blockDim.x)
    shared[i] = (uint32_t)tables[i];
  __syncthreads();
}

// Philox4x32-10 (Salmon et al. 2011): key = the 64-bit seed, counter =
// (row, step, 0, 0); the first output word.
__device__ __forceinline__ uint32_t philox_bits(uint32_t k0, uint32_t k1,
                                                uint32_t row, uint32_t step) {
  uint32_t c0 = row, c1 = step, c2 = 0u, c3 = 0u;
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Sizes 3-8 with their stack words: ceil(2 * (stones + caps) / 32).
#define TAK_DISPATCH_SIZE(n, CALL)        \
  switch (n) {                            \
    case 3: CALL(3, 1); break;            \
    case 4: CALL(4, 1); break;            \
    case 5: CALL(5, 2); break;            \
    case 6: CALL(6, 2); break;            \
    case 7: CALL(7, 3); break;            \
    case 8: CALL(8, 4); break;            \
    default: return (int)cudaErrorInvalidValue; \
  }
