// Device code of the env kernels that hold one Tak game in one warp, a
// square per lane (fused_step.cu, and the rollout of env_rollout.cu).
//
//   WarpGame<N, W>        lane l holds square l and, where n^2 > 32, square
//                         l + 32 (its "second slot"): the square's W stack
//                         words, height and top in registers; every lane
//                         keeps a copy of the game's scalars
//   warp_load/warp_store  lane q reads and writes its own square's fields,
//                         neighbouring lanes on neighbouring addresses
//   warp_step             one (assumed legal) action: the origin's lane
//                         computes the carried window and broadcasts it,
//                         each square of the ray inserts its own drop
//   warp_result           ownership bitboards by ballot; the four road
//                         planes (white / black, from the bottom / from the
//                         left) flood-fill on four groups of 8 lanes at once
//   warp_legal            per-square legal classes from the blocker and wall
//                         bitboards by shifts, no walk through memory
//   warp_sample           the uniform legal action in the reference's group
//                         order, by per-group warp sums and a warp scan
//   warp_reset            a finished game back to the start, komi kept
//
// "Squares ascending" is every first-slot square (0-31) before the second
// slot (32-63): the 64-bit ballot of the two slots is the board's bitboard.
// Semantics are those of the thread-per-row code of env_common.cuh (which
// the step-with-legal-bits and sampler kernels still run) and of the plain
// PyTorch versions; the kernels must agree with them bit for bit.

#pragma once

#include "env_common.cuh"

#define FULL_WARP 0xffffffffu

template <int N, int W>
struct WarpGame {
  static constexpr int N2 = N * N;
  static constexpr int S = (N2 + 31) / 32;        // squares a lane holds
  uint32_t words[S][W];
  int height[S];
  int top[S];
  int to_move, ply, half_komi, rev, result;
  int stones0, stones1, caps0, caps1;
};

// Warps per block for `rows` games, one warp a game: up to 8, fewer where
// that leaves SMs of the 132 without a block (64 games: 64 blocks of one
// warp, not 8 blocks of 8).
static inline int warps_per_block(int rows) {
  int w = 8;
  while (w > 1 && rows < 132 * w) w >>= 1;
  return w;
}

template <int W>
__device__ __forceinline__ uint32_t pick_word(const uint32_t (&w)[W], int j) {
  uint32_t v = 0u;
#pragma unroll
  for (int jj = 0; jj < W; ++jj)
    if (jj == j) v = w[jj];
  return v;
}

template <int N, int W>
__device__ __forceinline__ void warp_load(const StateIn& in, int r, int lane,
                                          WarpGame<N, W>& g) {
  constexpr int N2 = N * N;
#pragma unroll
  for (int s = 0; s < WarpGame<N, W>::S; ++s) {
    const int q = lane + 32 * s;
#pragma unroll
    for (int j = 0; j < W; ++j) g.words[s][j] = 0u;
    g.height[s] = 0;
    g.top[s] = EMPTY;
    if (q < N2) {
      const size_t at = (size_t)r * N2 + q;
#pragma unroll
      for (int j = 0; j < W; ++j)
        g.words[s][j] = (uint32_t)in.stacks[at * W + j];
      g.height[s] = in.heights[at];
      g.top[s] = in.tops[at];
    }
  }
  g.to_move = in.to_move[r]; g.ply = in.ply[r];
  g.half_komi = in.half_komi[r]; g.rev = in.reversible[r];
  g.result = in.result[r];
  g.stones0 = in.stones[2 * r]; g.stones1 = in.stones[2 * r + 1];
  g.caps0 = in.caps[2 * r]; g.caps1 = in.caps[2 * r + 1];
}

template <int N, int W>
__device__ __forceinline__ void warp_store(const StateOut& out, int r,
                                           int lane, const WarpGame<N, W>& g) {
  constexpr int N2 = N * N;
#pragma unroll
  for (int s = 0; s < WarpGame<N, W>::S; ++s) {
    const int q = lane + 32 * s;
    if (q < N2) {
      const size_t at = (size_t)r * N2 + q;
#pragma unroll
      for (int j = 0; j < W; ++j)
        out.stacks[at * W + j] = (long long)g.words[s][j];
      out.heights[at] = g.height[s];
      out.tops[at] = g.top[s];
    }
  }
  if (lane == 0) {
    out.to_move[r] = g.to_move; out.ply[r] = g.ply;
    out.stones[2 * r] = g.stones0; out.stones[2 * r + 1] = g.stones1;
    out.caps[2 * r] = g.caps0; out.caps[2 * r + 1] = g.caps1;
    out.half_komi[r] = g.half_komi; out.reversible[r] = g.rev;
    out.result[r] = g.result;
  }
}

// One step in place: board, reserves, to_move, ply, reversible.  The result
// field is left as it was (callers set it from warp_result).  `a` is the
// same in every lane.
template <int N, int W>
__device__ __forceinline__ void warp_step(WarpGame<N, W>& g, int a, int lane) {
  constexpr int N2 = N * N;
  constexpr int S = WarpGame<N, W>::S;
  constexpr int P = (1 << N) - 2;
  const int ch = a / N2, sq = a % N2;
  const bool is_place = ch < 3;
  const int to_move = g.to_move;
  const int color_eff = g.ply < 2 ? 1 - to_move : to_move;
  const int os = sq >> 5, ol = sq & 31;      // the origin's slot and lane

  // every lane takes its own square of the origin's slot; the origin's
  // lane's values are the ones kept
  int h_mine = 0, t_mine = EMPTY;
  uint32_t w_mine[W];
#pragma unroll
  for (int j = 0; j < W; ++j) w_mine[j] = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s == os) {
      h_mine = g.height[s];
      t_mine = g.top[s];
#pragma unroll
      for (int j = 0; j < W; ++j) w_mine[j] = g.words[s][j];
    }
  }
  const int h = __shfl_sync(FULL_WARP, h_mine, ol);
  const int orig_top = __shfl_sync(FULL_WARP, t_mine, ol);
  const int dp = ch - 3 > 0 ? ch - 3 : 0;
  const int d = dp / P, p = dp % P;
  const uint32_t mask = (uint32_t)(p + 1);           // n-bit drop pattern
  const int k = is_place ? 0 : N - (__ffs(mask) - 1);
  const int slen = __popc(mask);
  const int lo = h - k;
  const int lo0 = lo > 0 ? lo : 0;

  // carry window: k bits at height lo from the origin's words
  uint32_t carry;
  {
    const int j = lo0 >> 5, off = lo0 & 31;
    const uint32_t w0 = pick_word<W>(w_mine, j);
    const uint32_t w1 = pick_word<W>(w_mine, j + 1);
    const uint32_t hi = off == 0 ? 0u : (w1 << (32 - off < 31 ? 32 - off : 31));
    carry = __shfl_sync(FULL_WARP, ((w0 >> off) | hi) & ((1u << k) - 1u), ol);
  }

  // clear mask of the carried window at the origin
  const int cj = lo0 >> 5, coff = lo0 & 31;
  const uint32_t cmask = (1u << k) - 1u;
  const uint32_t cm0 = cmask << coff;
  const uint32_t cm1 = coff == 0 ? 0u
                                 : cmask >> (32 - coff < 31 ? 32 - coff : 31);

  const int srow = sq / N, scol = sq % N;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane + 32 * s;
    if (q >= N2) continue;
    const int row = q / N, col = q % N;
    int dist = 0;
    if (d == 0) dist = (col == scol && row > srow) ? row - srow : 0;
    else if (d == 1) dist = (row == srow && col > scol) ? col - scol : 0;
    else if (d == 2) dist = (col == scol && row < srow) ? srow - row : 0;
    else dist = (row == srow && col < scol) ? scol - col : 0;
    const bool on_ray = !is_place && dist >= 1 && dist <= slen;
    const bool origin = q == sq;
    if (!on_ray && !origin) continue;             // the square is untouched
    // this square's drop: the gap between the (dist-1)-th set bit of the
    // mask, read from the top, and the one before it; `cum` pieces of the
    // carry went to the squares before it
    int drop = 0, cum = 0;
    if (on_ray) {
      int js = 0, prev = -1;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if ((mask >> (N - 1 - i)) & 1u) {
          if (js == dist - 1) {
            drop = i - prev;
            cum = prev + 1;
          }
          prev = i;
          ++js;
        }
      }
    }
    const uint32_t bits = (carry >> cum) & ((1u << drop) - 1u);
    const uint32_t ins_bits =
        origin ? (is_place ? (uint32_t)color_eff : 0u) : bits;
    const int ins_count = is_place ? (origin ? 1 : 0) : drop;

    const int th = g.height[s];
    const int jw = th >> 5, offi = th & 31;
    const uint32_t w0 = ins_bits << offi;
    const uint32_t w1 = offi == 0 ? 0u
                                  : ins_bits >> (32 - offi < 31 ? 32 - offi : 31);
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      const uint32_t add = (jj == jw ? w0 : 0u) | (jj == jw + 1 ? w1 : 0u);
      uint32_t clr = 0u;
      if (!is_place && origin)
        clr = (jj == cj ? cm0 : 0u) | (jj == cj + 1 ? cm1 : 0u);
      g.words[s][jj] = (g.words[s][jj] & ~clr) | add;
    }
    if (origin) {
      g.height[s] = is_place ? 1 : lo;
      g.top[s] = is_place ? ch + 1 : (lo > 0 ? FLAT : EMPTY);
    } else {
      g.height[s] = th + ins_count;
      g.top[s] = dist == slen ? orig_top : FLAT;
    }
  }

  const bool is_cap_place = is_place && ch + 1 == CAP;
  if (is_place && !is_cap_place) {
    if (color_eff == 0) g.stones0 -= 1; else g.stones1 -= 1;
  }
  if (is_cap_place) {
    if (to_move == 0) g.caps0 -= 1; else g.caps1 -= 1;
  }
  g.to_move = 1 - to_move;
  g.ply += 1;
  g.rev = is_place ? 0 : g.rev + 1;
}

// Colour of the top piece of slot s (garbage where empty).
template <int N, int W>
__device__ __forceinline__ int warp_top_owner(const WarpGame<N, W>& g,
                                              int s) {
  const int h1 = g.height[s] - 1 > 0 ? g.height[s] - 1 : 0;
  return (int)((pick_word<W>(g.words[s], h1 >> 5) >> (h1 & 31)) & 1u);
}

// The 64-bit board of a per-square predicate (bit q = square q).
template <int S>
__device__ __forceinline__ uint64_t board_of(const bool (&pred)[S]) {
  uint64_t b = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    b |= (uint64_t)__ballot_sync(FULL_WARP, pred[s]) << (32 * s);
  return b;
}

// Result code of the position, g.to_move being the side to move now.  The
// same in every lane.
template <int N, int W>
__device__ __forceinline__ int warp_result(const WarpGame<N, W>& g, int lane) {
  constexpr int N2 = N * N;
  constexpr int S = WarpGame<N, W>::S;
  bool rw[S], rb[S], fw[S], fb[S], em[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = lane + 32 * s < N2;
    const int owner = warp_top_owner<N, W>(g, s);
    const int top = g.top[s];
    const bool roady = ok && g.height[s] > 0 && (top == FLAT || top == CAP);
    rw[s] = roady && owner == 0;
    rb[s] = roady && owner != 0;
    fw[s] = ok && top == FLAT && owner == 0;
    fb[s] = ok && top == FLAT && owner != 0;
    em[s] = ok && g.height[s] <= 0;
  }
  const uint64_t own_w = board_of<S>(rw), own_b = board_of<S>(rb);
  const int fd = __popcll(board_of<S>(fw)) - __popcll(board_of<S>(fb));
  const bool full = board_of<S>(em) == 0;

  const uint64_t all = N2 == 64 ? ~0ull : ((1ull << (N2 & 63)) - 1ull);
  uint64_t col0 = 0;
#pragma unroll
  for (int q = 0; q < N2; q += N) col0 |= 1ull << q;
  const uint64_t colL = col0 << (N - 1);
  const uint64_t bottom = (1ull << N) - 1ull;
  const uint64_t topr = bottom << (N2 - N);
  const uint64_t nc0 = all & ~col0, ncl = all & ~colL;
  // lanes 0-7: white from the bottom, 8-15: white from the left, 16-23 and
  // 24-31: black; each group fills its plane to the fixpoint
  const bool horiz = (lane & 8) != 0;
  const uint64_t own = (lane & 16) ? own_b : own_w;
  uint64_t lab = own & (horiz ? col0 : bottom);
  for (int it = 0; it < N2; ++it) {
    const uint64_t nl = (lab | ((lab << 1) & nc0) | ((lab >> 1) & ncl) |
                         (lab << N) | (lab >> N)) & own;
    const bool changed = nl != lab;
    lab = nl;
    if (!__any_sync(FULL_WARP, changed)) break;
  }
  const uint32_t hits =
      __ballot_sync(FULL_WARP, (lab & (horiz ? colL : topr)) != 0);
  const bool road_w = (hits & 0x0000FFFFu) != 0;
  const bool road_b = (hits & 0xFFFF0000u) != 0;

  const int to_move = g.to_move;
  const int just_moved = 1 - to_move;
  const bool road_jm = just_moved == 0 ? road_w : road_b;
  const bool road_om = just_moved == 0 ? road_b : road_w;
  if (road_jm) return just_moved == 0 ? WHITE_ROAD : BLACK_ROAD;
  if (road_om) return to_move == 0 ? WHITE_ROAD : BLACK_ROAD;
  const bool oor = (g.stones0 == 0 && g.caps0 == 0) ||
                   (g.stones1 == 0 && g.caps1 == 0);
  if (oor || full) {
    const int diff = fd - trunc_div2(g.half_komi);
    return diff > 0 ? WHITE_FLATS
           : (diff < 0 ? BLACK_FLATS
                       : (g.half_komi % 2 != 0 ? BLACK_FLATS : DRAW_FLATS));
  }
  return g.rev >= REVERSIBLE_PLIES ? DRAW_REVERSIBLE : ONGOING;
}

// ---------------------------------------------------------------------------
// Legal classes and the sample.  The pattern class tables are those of
// env_common.cuh, staged in shared memory by stage_tables; from them each
// block stages a count table (stage_counts): for each class (kidx, c,
// smash) the set bits of each spread word, two words' counts to a u32, so
// that a square's share of a word group's count is one shared-memory read.
// ---------------------------------------------------------------------------

template <int N>
struct CountDims {
  static constexpr int WP = LegalDims<N>::WP;
  static constexpr int PW = (WP + 1) / 2;      // u32 a class: 16-bit counts
  static constexpr int NOT_OWNED = N + 1;      // kidx of a square the mover
                                               // does not own: all zeros
  static constexpr int WORDS = (N + 2) * N * 2 * PW;
};

template <int N>
__device__ __forceinline__ void stage_counts(const uint32_t* tab,
                                             uint32_t* cnt) {
  constexpr int WP = CountDims<N>::WP, PW = CountDims<N>::PW;
  for (int i = threadIdx.x; i < CountDims<N>::WORDS; i += blockDim.x) {
    const int pw = i % PW, cls = i / PW;
    const int sm = cls % 2, c = (cls / 2) % N, k = cls / (2 * N);
    uint32_t v = 0u;
    if (k <= N) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = 2 * pw + h;
        if (w < WP) {
          const uint32_t word =
              tab[k * WP + w] & (tab[(N + 1 + c) * WP + w] |
                                 (sm ? tab[(2 * N + 1 + c) * WP + w] : 0u));
          v |= (uint32_t)__popc(word) << (16 * h);
        }
      }
    }
    cnt[i] = v;
  }
  __syncthreads();
}

template <int S>
struct WarpLegal {
  int place[S];        // bits 0/1/2: flat / wall / cap placement
  int kidx[S];         // min(height, N), or N + 1 where the mover does not own
  uint32_t rays[S];    // per direction d, 4 bits at 4d: c | smash << 3
};

// Along a line of n squares held as bits (a row, or a column of the
// transposed board), from position pos: the passable squares before the
// first blocker or the edge, and whether that blocker is a wall.
template <int N>
__device__ __forceinline__ uint32_t ray_up(uint32_t blk, uint32_t wal,
                                           int pos) {
  // a sentinel bit just past the edge ends the count at the room left
  const int c = __ffs((blk >> (pos + 1)) | (1u << (N - 1 - pos))) - 1;
  return (uint32_t)c | (((wal >> (pos + 1 + c)) & 1u) << 3);
}
__device__ __forceinline__ uint32_t ray_down(uint32_t blk, uint32_t wal,
                                             int pos) {
  const int hb = 31 - __clz(blk & ((1u << pos) - 1u));   // -1: none
  return (uint32_t)(pos - 1 - hb) | ((((wal << 1) >> (hb + 1)) & 1u) << 3);
}

template <int N, int W>
__device__ __forceinline__ void warp_legal(const WarpGame<N, W>& g, int lane,
                                           WarpLegal<WarpGame<N, W>::S>& L) {
  constexpr int N2 = N * N;
  constexpr int S = WarpGame<N, W>::S;
  constexpr uint32_t LINE = (1u << N) - 1u;
  const int to_move = g.to_move;
  const bool opening = g.ply < 2;
  const int color_eff = opening ? 1 - to_move : to_move;
  const bool have_stones = (color_eff == 0 ? g.stones0 : g.stones1) > 0;
  const bool have_caps = (to_move == 0 ? g.caps0 : g.caps1) > 0;

  // blockers (a wall or a capstone on top) and walls, and both transposed
  // (bit col * N + row), so that a column reads as a row
  bool blk[S], wal[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = lane + 32 * s < N2;
    blk[s] = ok && g.top[s] > FLAT;
    wal[s] = ok && g.top[s] == WALL;
  }
  const uint64_t bl = board_of<S>(blk), wl = board_of<S>(wal);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = lane + 32 * s;
    const int o = ((t % N) * N + t / N) & 63;
    blk[s] = t < N2 && ((bl >> o) & 1ull);
    wal[s] = t < N2 && ((wl >> o) & 1ull);
  }
  const uint64_t blt = board_of<S>(blk), wlt = board_of<S>(wal);

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane + 32 * s;
    const bool ok = q < N2;
    const int h = g.height[s];
    const bool empty = ok && h == 0;
    L.place[s] = (empty && have_stones ? 1 : 0) |
                 (empty && have_stones && !opening ? 2 : 0) |
                 (empty && have_caps && !opening ? 4 : 0);
    const bool own = ok && h > 0 && !opening &&
                     warp_top_owner<N, W>(g, s) == to_move;
    L.kidx[s] = own ? (h < N ? h : N) : CountDims<N>::NOT_OWNED;
    const int row = ok ? q / N : 0, col = ok ? q % N : 0;
    const uint32_t brow = (uint32_t)(bl >> (row * N)) & LINE;
    const uint32_t wrow = (uint32_t)(wl >> (row * N)) & LINE;
    const uint32_t bcol = (uint32_t)(blt >> (col * N)) & LINE;
    const uint32_t wcol = (uint32_t)(wlt >> (col * N)) & LINE;
    const uint32_t smash = g.top[s] == CAP ? 15u : 7u;   // keeps the wall bit
    L.rays[s] = own ? ((ray_up<N>(bcol, wcol, row) & smash) |
                       ((ray_up<N>(brow, wrow, col) & smash) << 4) |
                       ((ray_down(bcol, wcol, row) & smash) << 8) |
                       ((ray_down(brow, wrow, col) & smash) << 12))
                    : 0u;
  }
}

template <int N>
__device__ __forceinline__ uint32_t warp_spread_word(int kidx, uint32_t rays,
                                                     const uint32_t* tab,
                                                     int d, int w) {
  constexpr int WP = LegalDims<N>::WP;
  if (kidx > N) return 0u;
  const uint32_t ray = (rays >> (4 * d)) & 15u;
  const int c = (int)(ray & 7u);
  const uint32_t km = tab[kidx * WP + w];
  const uint32_t sm = tab[(N + 1 + c) * WP + w];
  const uint32_t sh = (ray & 8u) ? tab[(2 * N + 1 + c) * WP + w] : 0u;
  return km & (sm | sh);
}

// A square's counts (two 16-bit fields) in the word pair `pw` of
// direction d, from the count table.
template <int N>
__device__ __forceinline__ uint32_t class_counts(int kidx, uint32_t rays,
                                                 const uint32_t* cnt, int d,
                                                 int pw) {
  constexpr int PW = CountDims<N>::PW;
  const uint32_t ray = (rays >> (4 * d)) & 15u;
  const int cls = (kidx * N + (int)(ray & 7u)) * 2 + (int)(ray >> 3);
  return cnt[cls * PW + pw];
}

// Position of the k-th (from 0) set bit of w, which has more than k.
__device__ __forceinline__ int nth_set_bit(uint32_t w, int k) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const int lowc = __popc(w & ((1u << half) - 1u));
    if (k >= lowc) {
      k -= lowc;
      w >>= half;
      pos += half;
    }
  }
  return pos;
}

// Uniform legal action: r = bits % max(total, 1) (unsigned), counted over
// the groups place bit 0, 1, 2, then for d, w the word group (d, w), each
// over the squares ascending, set bits ascending inside a word.  The same
// action and total in every lane.
template <int N, int S>
__device__ __forceinline__ void warp_sample(const WarpLegal<S>& L,
                                            const uint32_t* tab,
                                            const uint32_t* ctab,
                                            uint32_t bits, int lane,
                                            int& action, int& total) {
  constexpr int N2 = N * N;
  constexpr int P = LegalDims<N>::P;
  constexpr int WP = LegalDims<N>::WP;
  constexpr int PW = CountDims<N>::PW;
  constexpr int G = 3 + 4 * WP;                   // groups, in order
  uint32_t cnt[G];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    bool set[S];
#pragma unroll
    for (int s = 0; s < S; ++s) set[s] = (L.place[s] >> b) & 1;
    cnt[b] = (uint32_t)__popcll(board_of<S>(set));
  }
  // a square's count in a word group is at most 32, a warp's at most
  // 2,048: two groups share one 32-bit warp sum
  if (WP == 1) {                                  // pairs of directions
#pragma unroll
    for (int d = 0; d < 4; d += 2) {
      uint32_t mine = 0u;
#pragma unroll
      for (int s = 0; s < S; ++s)
        mine += class_counts<N>(L.kidx[s], L.rays[s], ctab, d, 0) |
                class_counts<N>(L.kidx[s], L.rays[s], ctab, d + 1, 0) << 16;
      const uint32_t both = __reduce_add_sync(FULL_WARP, mine);
      cnt[3 + d] = both & 0xFFFFu;
      cnt[3 + d + 1] = both >> 16;
    }
  } else {                                        // pairs of words
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int pw = 0; pw < PW; ++pw) {
        uint32_t mine = 0u;
#pragma unroll
        for (int s = 0; s < S; ++s)
          mine += class_counts<N>(L.kidx[s], L.rays[s], ctab, d, pw);
        const uint32_t both = __reduce_add_sync(FULL_WARP, mine);
        cnt[3 + d * WP + 2 * pw] = both & 0xFFFFu;
        cnt[3 + d * WP + 2 * pw + 1] = both >> 16;
      }
    }
  }
  uint32_t tot = 0u;
#pragma unroll
  for (int g = 0; g < G; ++g) tot += cnt[g];
  total = (int)tot;
  action = 0;
  if (tot == 0u) return;
  uint32_t r = bits % tot;
  int gsel = 0;
  bool found = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!found) {
      if (r < cnt[g]) {
        gsel = g;
        found = true;
      } else {
        r -= cnt[g];
      }
    }
  }
  const unsigned lt = (1u << lane) - 1u;          // lanes below this one
  if (gsel < 3) {
    // the r-th placement of kind gsel, squares ascending
    uint32_t base = 0u;
    int q = 0;
    bool done = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool set = (L.place[s] >> gsel) & 1;
      const uint32_t m = __ballot_sync(FULL_WARP, set);
      const uint32_t pick = __ballot_sync(
          FULL_WARP, set && base + (uint32_t)__popc(m & lt) == r);
      if (!done && pick) {
        q = 32 * s + __ffs(pick) - 1;
        done = true;
      }
      base += (uint32_t)__popc(m);
    }
    action = gsel * N2 + q;
    return;
  }
  // the r-th set bit of word group (d, w): both slots' counts in one scan
  // over the lanes (16 bits each), slot 0's squares before slot 1's
  const int d = (gsel - 3) / WP, w = (gsel - 3) % WP;
  uint32_t word[S];
  uint32_t packed = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    word[s] = warp_spread_word<N>(L.kidx[s], L.rays[s], tab, d, w);
    packed |= (uint32_t)__popc(word[s]) << (16 * s);
  }
  uint32_t incl = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(FULL_WARP, incl, o);
    if (lane >= o) incl += v;
  }
  const uint32_t first = __shfl_sync(FULL_WARP, incl, 31) & 0xFFFFu;
  const int ss = (S > 1 && r >= first) ? 1 : 0;   // the slot of the pick
  const uint32_t rr = ss ? r - first : r;
  const uint32_t mine = (incl >> (16 * ss)) & 0xFFFFu;
  uint32_t wsel = word[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (s == ss) wsel = word[s];
  const int src = __ffs(__ballot_sync(FULL_WARP, mine > rr)) - 1;
  const int bit = nth_set_bit(wsel, (int)(rr - (mine - __popc(wsel))));
  action = __shfl_sync(FULL_WARP,
                       (3 + d * P + w * 32 + bit) * N2 + lane + 32 * ss, src);
}

// A finished game restarts from the initial position; komi is kept.
template <int N, int W>
__device__ __forceinline__ void warp_reset(WarpGame<N, W>& g,
                                           int start_stones, int start_caps) {
#pragma unroll
  for (int s = 0; s < WarpGame<N, W>::S; ++s) {
#pragma unroll
    for (int j = 0; j < W; ++j) g.words[s][j] = 0u;
    g.height[s] = 0;
    g.top[s] = EMPTY;
  }
  g.to_move = 0; g.ply = 0; g.rev = 0; g.result = ONGOING;
  g.stones0 = g.stones1 = start_stones;
  g.caps0 = g.caps1 = start_caps;
}
