// Fused Tak env step for Hopper (sm_90a): step + result + freeze in one pass.
//
// Replaces tak_tpu/engine/pallas_env.py:704 build_fused_step (_step_core,
// _roads, _compute_result and the done/disabled freeze).  The plain PyTorch
// version (tak_tpu_torch/engine/fused_env.py: step_plain) states the
// semantics; this file must agree with it bit for bit.
//
// Layout: the GameState fields in their batch-first layout (stacks int64
// [R, n2, W] carrying u32 values, heights/tops int32 [R, n2], per-row int32
// scalars, stones/caps int32 [R, 2]); one thread per row.  Roads are a flood
// fill on two 64-bit bitboards (bit q = square q) in registers.
//
// What bounds it: bytes (about 0.9 KB read and written per 6x6 row for a few
// hundred integer operations).  The whole step, the result and the freeze run
// in one pass so every byte moves once.

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

__device__ __forceinline__ int trunc_div2(int x) {
  return x >= 0 ? x / 2 : -((-x) / 2);
}

template <int N, int W>
__global__ void fused_step_kernel(StateIn in, StateOut out,
                                  const int* action,
                                  const unsigned char* enabled, int rows) {
  constexpr int N2 = N * N;
  constexpr int P = (1 << N) - 2;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;

  const long long* st_in = in.stacks + (size_t)r * N2 * W;
  const int* h_in = in.heights + (size_t)r * N2;
  const int* t_in = in.tops + (size_t)r * N2;
  long long* st_out = out.stacks + (size_t)r * N2 * W;
  int* h_out = out.heights + (size_t)r * N2;
  int* t_out = out.tops + (size_t)r * N2;

  const int to_move = in.to_move[r], ply = in.ply[r];
  const int half_komi = in.half_komi[r], rev = in.reversible[r];
  const int result = in.result[r];
  int stones[2] = {in.stones[2 * r], in.stones[2 * r + 1]};
  int caps[2] = {in.caps[2 * r], in.caps[2 * r + 1]};

  const bool done = result != ONGOING || !enabled[r];
  if (done) {
    for (int i = 0; i < N2 * W; ++i) st_out[i] = st_in[i];
    for (int q = 0; q < N2; ++q) { h_out[q] = h_in[q]; t_out[q] = t_in[q]; }
    out.to_move[r] = to_move; out.ply[r] = ply;
    out.stones[2 * r] = stones[0]; out.stones[2 * r + 1] = stones[1];
    out.caps[2 * r] = caps[0]; out.caps[2 * r + 1] = caps[1];
    out.half_komi[r] = half_komi; out.reversible[r] = rev;
    out.result[r] = result;
    return;
  }

  // ---- decode ----
  const int a = action[r];
  const int ch = a / N2, sq = a % N2;
  const bool is_place = ch < 3;
  const int color_eff = ply < 2 ? 1 - to_move : to_move;
  const int orig_top = t_in[sq];
  const int h = h_in[sq];
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
    const uint32_t w0 = j < W ? (uint32_t)st_in[sq * W + j] : 0u;
    const uint32_t w1 = j + 1 < W ? (uint32_t)st_in[sq * W + j + 1] : 0u;
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
  int heights[N2], tops[N2];
  uint32_t words[N2][W];
  for (int q = 0; q < N2; ++q) {
    const int row = q / N, col = q % N;
    int dist = 0;
    if (d == 0) dist = (col == scol && row > srow) ? row - srow : 0;
    else if (d == 1) dist = (row == srow && col > scol) ? col - scol : 0;
    else if (d == 2) dist = (col == scol && row < srow) ? srow - row : 0;
    else dist = (row == srow && col < scol) ? scol - col : 0;
    const bool on_ray = !is_place && dist >= 1 && dist <= slen;
    const int drop = on_ray ? drops[dist - 1] : 0;
    const int cum = on_ray ? cumd[dist - 1] : 0;
    const uint32_t bits = (carry >> cum) & ((1u << drop) - 1u);
    const bool origin = q == sq;
    const uint32_t ins_bits =
        origin ? (is_place ? (uint32_t)color_eff : 0u) : bits;
    const int ins_count = is_place ? (origin ? 1 : 0) : drop;

    const int th = h_in[q];
    const int jw = th >> 5, offi = th & 31;
    const uint32_t w0 = ins_bits << offi;
    const uint32_t w1 = offi == 0 ? 0u
                                  : ins_bits >> (32 - offi < 31 ? 32 - offi : 31);
    for (int jj = 0; jj < W; ++jj) {
      uint32_t add = (jj == jw ? w0 : 0u) | (jj == jw + 1 ? w1 : 0u);
      uint32_t clr = 0u;
      if (!is_place && origin)
        clr = (jj == cj ? cm0 : 0u) | (jj == cj + 1 ? cm1 : 0u);
      words[q][jj] = ((uint32_t)st_in[q * W + jj] & ~clr) | add;
    }
    if (origin) {
      heights[q] = is_place ? 1 : lo;
      tops[q] = is_place ? ch + 1 : (lo > 0 ? FLAT : EMPTY);
    } else {
      heights[q] = th + ins_count;
      tops[q] = on_ray ? (dist == slen ? orig_top : FLAT) : t_in[q];
    }
  }

  // ---- scalars ----
  const bool is_cap_place = is_place && ch + 1 == CAP;
  if (is_place && !is_cap_place) stones[color_eff] -= 1;
  if (is_cap_place) caps[to_move] -= 1;
  const int nto_move = 1 - to_move;
  const int nrev = is_place ? 0 : rev + 1;

  // ---- result ----
  uint64_t own_w = 0, own_b = 0;
  int fd = 0;
  bool full = true;
  for (int q = 0; q < N2; ++q) {
    const int h1 = heights[q] - 1 > 0 ? heights[q] - 1 : 0;
    const int owner = (words[q][h1 >> 5] >> (h1 & 31)) & 1u;
    const bool roady = heights[q] > 0 && (tops[q] == FLAT || tops[q] == CAP);
    if (roady) {
      if (owner == 0) own_w |= 1ull << q; else own_b |= 1ull << q;
    }
    if (tops[q] == FLAT) fd += 1 - 2 * owner;
    if (heights[q] <= 0) full = false;
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
  const int just_moved = 1 - nto_move;
  const bool road_jm = just_moved == 0 ? road[0] : road[1];
  const bool road_om = just_moved == 0 ? road[1] : road[0];
  int code;
  if (road_jm) code = just_moved == 0 ? WHITE_ROAD : BLACK_ROAD;
  else if (road_om) code = nto_move == 0 ? WHITE_ROAD : BLACK_ROAD;
  else {
    const bool oor = (stones[0] == 0 && caps[0] == 0) ||
                     (stones[1] == 0 && caps[1] == 0);
    if (oor || full) {
      const int diff = fd - trunc_div2(half_komi);
      code = diff > 0 ? WHITE_FLATS
             : (diff < 0 ? BLACK_FLATS
                         : (half_komi % 2 != 0 ? BLACK_FLATS : DRAW_FLATS));
    } else {
      code = nrev >= REVERSIBLE_PLIES ? DRAW_REVERSIBLE : ONGOING;
    }
  }

  for (int q = 0; q < N2; ++q) {
    for (int jj = 0; jj < W; ++jj) st_out[q * W + jj] = (long long)words[q][jj];
    h_out[q] = heights[q];
    t_out[q] = tops[q];
  }
  out.to_move[r] = nto_move;
  out.ply[r] = ply + 1;
  out.stones[2 * r] = stones[0]; out.stones[2 * r + 1] = stones[1];
  out.caps[2 * r] = caps[0]; out.caps[2 * r + 1] = caps[1];
  out.half_komi[r] = half_komi;
  out.reversible[r] = nrev;
  out.result[r] = code;
}

template <int N, int W>
static void launch(StateIn in, StateOut out, const int* action,
                   const unsigned char* enabled, int rows, cudaStream_t s) {
  const int threads = 128;
  fused_step_kernel<N, W><<<(rows + threads - 1) / threads, threads, 0, s>>>(
      in, out, action, enabled, rows);
}

extern "C" int tak_fused_step(
    int n, int rows,
    void* i0, void* i1, void* i2, void* i3, void* i4, void* i5, void* i6,
    void* i7, void* i8, void* i9,
    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5, void* o6,
    void* o7, void* o8, void* o9,
    void* action, void* enabled, void* stream) {
  StateIn in = {(const long long*)i0, (const int*)i1, (const int*)i2,
                (const int*)i3, (const int*)i4, (const int*)i5,
                (const int*)i6, (const int*)i7, (const int*)i8,
                (const int*)i9};
  StateOut out = {(long long*)o0, (int*)o1, (int*)o2, (int*)o3, (int*)o4,
                  (int*)o5, (int*)o6, (int*)o7, (int*)o8, (int*)o9};
  const int* act = (const int*)action;
  const unsigned char* en = (const unsigned char*)enabled;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {  // stack words: ceil(2 * (stones + caps) / 32)
    case 3: launch<3, 1>(in, out, act, en, rows, s); break;
    case 4: launch<4, 1>(in, out, act, en, rows, s); break;
    case 5: launch<5, 2>(in, out, act, en, rows, s); break;
    case 6: launch<6, 2>(in, out, act, en, rows, s); break;
    case 7: launch<7, 3>(in, out, act, en, rows, s); break;
    case 8: launch<8, 4>(in, out, act, en, rows, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
