// Fused Tak env step with the packed legal bits of the result, for Hopper
// (sm_90a).
//
// Replaces tak_tpu/engine/pallas_env.py:836 build_fused_step_legal: the fused
// step (step + result + freeze, as fused_step.cu) and, from the row still in
// registers, the packed legal-move words of the OUTPUT state, frozen rows and
// finished games included (callers gate terminal leaves):
//   place  int32 [R, n2]         bits 0/1/2 = flat / wall / cap placement
//   spread int32 [R, 4, wp, n2]  bit b of word w = drop pattern w*32 + b
// The words are u32 bit patterns in int32 storage (bit 31 is a live pattern
// at 6x6).  The plain PyTorch version is engine/legal_bits.py
// step_legal_plain; this file must agree with it bit for bit.
//
// One warp per row, a square per lane (env_warp.cuh), as the fused step:
// the step and the result of fused_step.cu, then warp_legal on the state as
// stored (the blocker and wall bitboards by ballot, each square's rays by
// shifts of its row and column words), and each lane writes its own
// squares' words, so that neighbouring lanes store neighbouring words.  The
// Pallas kernel's sublane shifts, prefix scans and one-hot table selects
// are not carried over: the class tables sit in shared memory and are
// indexed directly.
//
// What bounds it: bytes.  A 6x6 row moves the step's 0.9 KB each way plus
// 1,296 B of words out, for a few hundred warp instructions.  Emitting the
// words here replaces a dense [R, A] bool mask (9,036 B per 6x6 row) built
// by some thirty tensor passes.  8,192 rows are 1,024 blocks of 8 warps;
// 64 rows (a Player wave) are 64 blocks of one warp.

#include "env_warp.cuh"

template <int N, int W>
__global__ void fused_step_legal_kernel(StateIn in, StateOut out,
                                        const int* action,
                                        const unsigned char* enabled,
                                        const int* tables, int* place,
                                        int* spread, int rows) {
  constexpr int N2 = N * N;
  constexpr int S = WarpGame<N, W>::S;
  constexpr int WP = LegalDims<N>::WP;
  __shared__ uint32_t tab[LegalDims<N>::TABLE_WORDS];
  stage_tables<N>(tables, tab);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;                     // the whole warp: r is its row
  WarpGame<N, W> g;
  warp_load<N, W>(in, r, lane, g);
  if (g.result == ONGOING && enabled[r]) {   // else the row comes back frozen
    warp_step<N, W>(g, action[r], lane);
    g.result = warp_result<N, W>(g, lane);
  }
  warp_store<N, W>(out, r, lane, g);

  // the words of the state as stored, frozen and finished rows included
  WarpLegal<S> L;
  warp_legal<N, W>(g, lane, L);
  int* pl = place + (size_t)r * N2;
  int* sp = spread + (size_t)r * 4 * WP * N2;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane + 32 * s;
    if (q >= N2) continue;
    pl[q] = L.place[s];
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int w = 0; w < WP; ++w)
        sp[(size_t)(d * WP + w) * N2 + q] =
            (int)warp_spread_word<N>(L.kidx[s], L.rays[s], tab, d, w);
  }
}

template <int N, int W>
static void launch(StateIn in, StateOut out, const int* action,
                   const unsigned char* enabled, const int* tables, int* place,
                   int* spread, int rows, cudaStream_t s) {
  const int warps = warps_per_block(rows);
  fused_step_legal_kernel<N, W>
      <<<(rows + warps - 1) / warps, 32 * warps, 0, s>>>(
          in, out, action, enabled, tables, place, spread, rows);
}

extern "C" int tak_fused_step_legal(
    int n, int rows,
    void* i0, void* i1, void* i2, void* i3, void* i4, void* i5, void* i6,
    void* i7, void* i8, void* i9,
    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5, void* o6,
    void* o7, void* o8, void* o9,
    void* action, void* enabled, void* tables, void* place, void* spread,
    void* stream) {
  void* ins[10] = {i0, i1, i2, i3, i4, i5, i6, i7, i8, i9};
  void* outs[10] = {o0, o1, o2, o3, o4, o5, o6, o7, o8, o9};
  const StateIn in = state_in(ins);
  const StateOut out = state_out(outs);
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(N_, W_)                                                        \
  launch<N_, W_>(in, out, (const int*)action, (const unsigned char*)enabled, \
                 (const int*)tables, (int*)place, (int*)spread, rows, s)
  TAK_DISPATCH_SIZE(n, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
