// Device code of the env kernels that hold one Tak row in one thread (the
// step with legal bits of fused_step_legal.cu and the legal sampler of
// env_rollout.cu), and what the warp-per-game kernels of env_warp.cuh share
// with them (the state's layout, the pattern class tables, Philox).
//
//   Row<N, W>          the state of one game in registers / local memory
//   load_row/store_row batch-first GameState fields <-> Row
//   step_row           one (assumed legal) action, in place, without the result
//   result_of          result code of a position (roads by bitboard flood fill)
//   LegalRow<N>        per-square legality classes, from which every packed
//                      legal word is two table lookups and an AND
//   sample_action      uniform legal action in the reference's group order
//   philox_bits        Philox4x32-10, key = seed, counter = (row, step)
//
// Semantics are those of the plain PyTorch versions (engine/fused_env.py
// step_plain, engine/legal_bits.py legal_bits_plain, engine/env_rollout.py
// sample_action_plain / philox_bits_plain); the kernels must agree with them
// bit for bit.

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

template <int N, int W>
struct Row {
  uint32_t words[N * N][W];
  int heights[N * N];
  int tops[N * N];
  int to_move, ply, half_komi, rev, result;
  int stones[2], caps[2];
};

template <int N, int W>
__device__ __forceinline__ void load_row(const StateIn& in, int r,
                                         Row<N, W>& s) {
  constexpr int N2 = N * N;
  const long long* st = in.stacks + (size_t)r * N2 * W;
  const int* h = in.heights + (size_t)r * N2;
  const int* t = in.tops + (size_t)r * N2;
  for (int q = 0; q < N2; ++q) {
    for (int j = 0; j < W; ++j) s.words[q][j] = (uint32_t)st[q * W + j];
    s.heights[q] = h[q];
    s.tops[q] = t[q];
  }
  s.to_move = in.to_move[r]; s.ply = in.ply[r];
  s.half_komi = in.half_komi[r]; s.rev = in.reversible[r];
  s.result = in.result[r];
  s.stones[0] = in.stones[2 * r]; s.stones[1] = in.stones[2 * r + 1];
  s.caps[0] = in.caps[2 * r]; s.caps[1] = in.caps[2 * r + 1];
}

template <int N, int W>
__device__ __forceinline__ void store_row(const StateOut& out, int r,
                                          const Row<N, W>& s) {
  constexpr int N2 = N * N;
  long long* st = out.stacks + (size_t)r * N2 * W;
  int* h = out.heights + (size_t)r * N2;
  int* t = out.tops + (size_t)r * N2;
  for (int q = 0; q < N2; ++q) {
    for (int j = 0; j < W; ++j) st[q * W + j] = (long long)s.words[q][j];
    h[q] = s.heights[q];
    t[q] = s.tops[q];
  }
  out.to_move[r] = s.to_move; out.ply[r] = s.ply;
  out.stones[2 * r] = s.stones[0]; out.stones[2 * r + 1] = s.stones[1];
  out.caps[2 * r] = s.caps[0]; out.caps[2 * r + 1] = s.caps[1];
  out.half_komi[r] = s.half_komi; out.reversible[r] = s.rev;
  out.result[r] = s.result;
}

__device__ __forceinline__ int trunc_div2(int x) {
  return x >= 0 ? x / 2 : -((-x) / 2);
}

// The square after q along direction d (0 up +N, 1 right +1, 2 down -N,
// 3 left -1), or -1 off the board.
template <int N>
__device__ __forceinline__ int next_square(int q, int d) {
  const int row = q / N, col = q % N;
  if (d == 0) return row + 1 < N ? q + N : -1;
  if (d == 1) return col + 1 < N ? q + 1 : -1;
  if (d == 2) return row > 0 ? q - N : -1;
  return col > 0 ? q - 1 : -1;
}

// One step in place: board, reserves, to_move, ply, reversible.  The result
// field is left as it was (callers set it from result_of).
template <int N, int W>
__device__ void step_row(Row<N, W>& s, int a) {
  constexpr int N2 = N * N;
  constexpr int P = (1 << N) - 2;
  const int ch = a / N2, sq = a % N2;
  const bool is_place = ch < 3;
  const int to_move = s.to_move;
  const int color_eff = s.ply < 2 ? 1 - to_move : to_move;
  const int orig_top = s.tops[sq];
  const int h = s.heights[sq];
  const int dp = ch - 3 > 0 ? ch - 3 : 0;
  const int d = dp / P, p = dp % P;
  const uint32_t mask = (uint32_t)(p + 1);           // n-bit drop pattern
  const int k = is_place ? 0 : N - (__ffs(mask) - 1);
  const int slen = __popc(mask);
  const int lo = h - k;
  const int lo0 = lo > 0 ? lo : 0;

  // drops along the ray: set bits of the mask, counted from the top
  int drops[N], cumd[N];
  {
    int js = 0, prev = -1, acc = 0;
    for (int i = 0; i < N; ++i) { drops[i] = 0; cumd[i] = 0; }
    for (int i = 0; i < N; ++i) {
      if ((mask >> (N - 1 - i)) & 1u) {
        drops[js] = i - prev;
        cumd[js] = acc;
        acc += i - prev;
        prev = i;
        ++js;
      }
    }
  }

  // carry window: k bits at height lo from the origin's words
  uint32_t carry;
  {
    const int j = lo0 >> 5, off = lo0 & 31;
    uint32_t w0 = 0u, w1 = 0u;
    for (int jj = 0; jj < W; ++jj) {
      if (jj == j) w0 = s.words[sq][jj];
      if (jj == j + 1) w1 = s.words[sq][jj];
    }
    const uint32_t hi = off == 0 ? 0u : (w1 << (32 - off < 31 ? 32 - off : 31));
    carry = ((w0 >> off) | hi) & ((1u << k) - 1u);
  }

  // clear mask of the carried window at the origin
  const int cj = lo0 >> 5, coff = lo0 & 31;
  const uint32_t cmask = (1u << k) - 1u;
  const uint32_t cm0 = cmask << coff;
  const uint32_t cm1 = coff == 0 ? 0u
                                 : cmask >> (32 - coff < 31 ? 32 - coff : 31);

  const int srow = sq / N, scol = sq % N;
  for (int q = 0; q < N2; ++q) {
    const int row = q / N, col = q % N;
    int dist = 0;
    if (d == 0) dist = (col == scol && row > srow) ? row - srow : 0;
    else if (d == 1) dist = (row == srow && col > scol) ? col - scol : 0;
    else if (d == 2) dist = (col == scol && row < srow) ? srow - row : 0;
    else dist = (row == srow && col < scol) ? scol - col : 0;
    const bool on_ray = !is_place && dist >= 1 && dist <= slen;
    const bool origin = q == sq;
    if (!on_ray && !origin) continue;             // the square is untouched
    const int drop = on_ray ? drops[dist - 1] : 0;
    const int cum = on_ray ? cumd[dist - 1] : 0;
    const uint32_t bits = (carry >> cum) & ((1u << drop) - 1u);
    const uint32_t ins_bits =
        origin ? (is_place ? (uint32_t)color_eff : 0u) : bits;
    const int ins_count = is_place ? (origin ? 1 : 0) : drop;

    const int th = s.heights[q];
    const int jw = th >> 5, offi = th & 31;
    const uint32_t w0 = ins_bits << offi;
    const uint32_t w1 = offi == 0 ? 0u
                                  : ins_bits >> (32 - offi < 31 ? 32 - offi : 31);
    for (int jj = 0; jj < W; ++jj) {
      const uint32_t add = (jj == jw ? w0 : 0u) | (jj == jw + 1 ? w1 : 0u);
      uint32_t clr = 0u;
      if (!is_place && origin)
        clr = (jj == cj ? cm0 : 0u) | (jj == cj + 1 ? cm1 : 0u);
      s.words[q][jj] = (s.words[q][jj] & ~clr) | add;
    }
    if (origin) {
      s.heights[q] = is_place ? 1 : lo;
      s.tops[q] = is_place ? ch + 1 : (lo > 0 ? FLAT : EMPTY);
    } else {
      s.heights[q] = th + ins_count;
      s.tops[q] = dist == slen ? orig_top : FLAT;
    }
  }

  const bool is_cap_place = is_place && ch + 1 == CAP;
  if (is_place && !is_cap_place) s.stones[color_eff] -= 1;
  if (is_cap_place) s.caps[to_move] -= 1;
  s.to_move = 1 - to_move;
  s.ply += 1;
  s.rev = is_place ? 0 : s.rev + 1;
}

template <int N, int W>
__device__ __forceinline__ int top_owner(const Row<N, W>& s, int q) {
  const int h1 = s.heights[q] - 1 > 0 ? s.heights[q] - 1 : 0;
  const int j = h1 >> 5;
  uint32_t w = 0u;
  for (int jj = 0; jj < W; ++jj)
    if (jj == j) w = s.words[q][jj];
  return (int)((w >> (h1 & 31)) & 1u);
}

// Result code of the position, s.to_move being the side to move now.
template <int N, int W>
__device__ int result_of(const Row<N, W>& s) {
  constexpr int N2 = N * N;
  uint64_t own_w = 0, own_b = 0;
  int fd = 0;
  bool full = true;
  for (int q = 0; q < N2; ++q) {
    const int owner = top_owner<N, W>(s, q);
    const int top = s.tops[q];
    const bool roady = s.heights[q] > 0 && (top == FLAT || top == CAP);
    if (roady) {
      if (owner == 0) own_w |= 1ull << q; else own_b |= 1ull << q;
    }
    if (top == FLAT) fd += 1 - 2 * owner;
    if (s.heights[q] <= 0) full = false;
  }
  const uint64_t all = N2 == 64 ? ~0ull : ((1ull << (N2 & 63)) - 1ull);
  uint64_t col0 = 0;
  for (int q = 0; q < N2; q += N) col0 |= 1ull << q;
  const uint64_t colL = col0 << (N - 1);
  const uint64_t bottom = (1ull << N) - 1ull;
  const uint64_t top = bottom << (N2 - N);
  const uint64_t nc0 = all & ~col0, ncl = all & ~colL;
  bool road[2];
  for (int c = 0; c < 2; ++c) {
    const uint64_t own = c == 0 ? own_w : own_b;
    uint64_t lv = own & bottom, lh = own & col0;
    for (int it = 0; it < N2; ++it) {
      const uint64_t nv = (lv | ((lv << 1) & nc0) | ((lv >> 1) & ncl) |
                           (lv << N) | (lv >> N)) & own;
      const uint64_t nh = (lh | ((lh << 1) & nc0) | ((lh >> 1) & ncl) |
                           (lh << N) | (lh >> N)) & own;
      if (nv == lv && nh == lh) break;
      lv = nv;
      lh = nh;
    }
    road[c] = (lv & top) != 0 || (lh & colL) != 0;
  }
  const int to_move = s.to_move;
  const int just_moved = 1 - to_move;
  const bool road_jm = just_moved == 0 ? road[0] : road[1];
  const bool road_om = just_moved == 0 ? road[1] : road[0];
  if (road_jm) return just_moved == 0 ? WHITE_ROAD : BLACK_ROAD;
  if (road_om) return to_move == 0 ? WHITE_ROAD : BLACK_ROAD;
  const bool oor = (s.stones[0] == 0 && s.caps[0] == 0) ||
                   (s.stones[1] == 0 && s.caps[1] == 0);
  if (oor || full) {
    const int diff = fd - trunc_div2(s.half_komi);
    return diff > 0 ? WHITE_FLATS
           : (diff < 0 ? BLACK_FLATS
                       : (s.half_komi % 2 != 0 ? BLACK_FLATS : DRAW_FLATS));
  }
  return s.rev >= REVERSIBLE_PLIES ? DRAW_REVERSIBLE : ONGOING;
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

#define NOT_OWN 0xFF

template <int N>
struct LegalRow {
  unsigned char place[N * N];     // bits 0/1/2: flat / wall / cap placement
  unsigned char kidx[N * N];      // min(height, N), or NOT_OWN
  unsigned char ray[N * N][4];    // c | smash << 3
};

template <int N, int W>
__device__ void legal_prepare(const Row<N, W>& s, LegalRow<N>& g) {
  constexpr int N2 = N * N;
  const int to_move = s.to_move;
  const bool opening = s.ply < 2;
  const int color_eff = opening ? 1 - to_move : to_move;
  const bool have_stones = s.stones[color_eff] > 0;
  const bool have_caps = s.caps[to_move] > 0;
  for (int q = 0; q < N2; ++q) {
    const int h = s.heights[q];
    const bool empty = h == 0;
    g.place[q] = (unsigned char)((empty && have_stones ? 1 : 0) |
                                 (empty && have_stones && !opening ? 2 : 0) |
                                 (empty && have_caps && !opening ? 4 : 0));
    const bool own = h > 0 && !opening && top_owner<N, W>(s, q) == to_move;
    g.kidx[q] = own ? (unsigned char)(h < N ? h : N) : (unsigned char)NOT_OWN;
    if (!own) continue;
    const bool cap_origin = s.tops[q] == CAP;
    for (int d = 0; d < 4; ++d) {
      int c = 0;
      bool wall = false;
      for (int at = next_square<N>(q, d); at >= 0;
           at = next_square<N>(at, d)) {
        const int top = s.tops[at];
        if (top <= FLAT) { ++c; continue; }
        wall = top == WALL;
        break;
      }
      g.ray[q][d] = (unsigned char)(c | (wall && cap_origin ? 8 : 0));
    }
  }
}

template <int N>
__device__ __forceinline__ uint32_t spread_word(const LegalRow<N>& g,
                                                const uint32_t* tab, int q,
                                                int d, int w) {
  constexpr int WP = LegalDims<N>::WP;
  const int ki = g.kidx[q];
  if (ki == NOT_OWN) return 0u;
  const int c = g.ray[q][d] & 7;
  const uint32_t km = tab[ki * WP + w];
  const uint32_t sm = tab[(N + 1 + c) * WP + w];
  const uint32_t sh = (g.ray[q][d] & 8) ? tab[(2 * N + 1 + c) * WP + w] : 0u;
  return km & (sm | sh);
}

// Uniform legal action: r = bits % max(total, 1) (unsigned), counted over the
// groups place bit 0, 1, 2 (squares ascending), then for d, w the word group
// (d, w) over squares ascending and set bits ascending inside a word.
template <int N>
__device__ void sample_action(const LegalRow<N>& g, const uint32_t* tab,
                              uint32_t bits, int& action, int& total) {
  constexpr int N2 = N * N;
  constexpr int P = LegalDims<N>::P;
  constexpr int WP = LegalDims<N>::WP;
  int tot = 0;
  for (int q = 0; q < N2; ++q) {
    tot += __popc((uint32_t)g.place[q]);
    if (g.kidx[q] == NOT_OWN) continue;
    for (int d = 0; d < 4; ++d)
      for (int w = 0; w < WP; ++w) tot += __popc(spread_word<N>(g, tab, q, d, w));
  }
  total = tot;
  action = 0;
  if (tot == 0) return;
  uint32_t r = bits % (uint32_t)tot;
  for (int b = 0; b < 3; ++b) {
    for (int q = 0; q < N2; ++q) {
      if (!((g.place[q] >> b) & 1)) continue;
      if (r == 0) { action = b * N2 + q; return; }
      --r;
    }
  }
  for (int d = 0; d < 4; ++d) {
    for (int w = 0; w < WP; ++w) {
      for (int q = 0; q < N2; ++q) {
        uint32_t word = spread_word<N>(g, tab, q, d, w);
        const uint32_t cnt = (uint32_t)__popc(word);
        if (r >= cnt) { r -= cnt; continue; }
        for (; r > 0; --r) word &= word - 1u;     // drop the r lowest set bits
        const int bit = __ffs(word) - 1;
        action = (3 + d * P + w * 32 + bit) * N2 + q;
        return;
      }
    }
  }
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
