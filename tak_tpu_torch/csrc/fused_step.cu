// Fused Tak env step for Hopper (sm_90a): step + result + freeze in one pass.
//
// Replaces tak_tpu/engine/pallas_env.py:704 build_fused_step (_step_core,
// _roads, _compute_result and the done/disabled freeze).  The plain PyTorch
// version (tak_tpu_torch/engine/fused_env.py: step_plain) states the
// semantics; this file must agree with it bit for bit.
//
// Layout: the GameState fields in their batch-first layout (stacks int64
// [R, n2, W] carrying u32 values, heights/tops int32 [R, n2], per-row int32
// scalars, stones/caps int32 [R, 2]).  One warp per row, a square per lane
// (env_warp.cuh): the row's loads are coalesced across the lanes, a spread's
// squares insert their drops in parallel, and the road flood fill runs on
// bitboards made by ballots, its four planes on four lane groups.
//
// What bounds it: bytes (about 0.9 KB read and written per 6x6 row for a few
// hundred integer operations).  The whole step, the result and the freeze
// run in one pass so every byte moves once.  A row's time is one chain of a
// load, a few shuffles and ballots, the fill's iterations and a store; with
// a warp per row, 8,192 rows are 1,024 blocks of 8 warps over the 132 SMs,
// and 64 rows are 64 blocks of one warp.

#include "env_warp.cuh"

template <int N, int W>
__global__ void fused_step_kernel(StateIn in, StateOut out,
                                  const int* action,
                                  const unsigned char* enabled, int rows) {
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
}

template <int N, int W>
static void launch(StateIn in, StateOut out, const int* action,
                   const unsigned char* enabled, int rows, cudaStream_t s) {
  const int warps = warps_per_block(rows);
  fused_step_kernel<N, W><<<(rows + warps - 1) / warps, 32 * warps, 0, s>>>(
      in, out, action, enabled, rows);
}

extern "C" int tak_fused_step(
    int n, int rows,
    void* i0, void* i1, void* i2, void* i3, void* i4, void* i5, void* i6,
    void* i7, void* i8, void* i9,
    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5, void* o6,
    void* o7, void* o8, void* o9,
    void* action, void* enabled, void* stream) {
  void* ins[10] = {i0, i1, i2, i3, i4, i5, i6, i7, i8, i9};
  void* outs[10] = {o0, o1, o2, o3, o4, o5, o6, o7, o8, o9};
  const StateIn in = state_in(ins);
  const StateOut out = state_out(outs);
  const int* act = (const int*)action;
  const unsigned char* en = (const unsigned char*)enabled;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(N_, W_) launch<N_, W_>(in, out, act, en, rows, s)
  TAK_DISPATCH_SIZE(n, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
