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
// in one pass so every byte moves once.  The step and the result are the
// shared device code of env_common.cuh (also run by fused_step_legal.cu and
// env_rollout.cu).

#include "env_common.cuh"

template <int N, int W>
__global__ void fused_step_kernel(StateIn in, StateOut out,
                                  const int* action,
                                  const unsigned char* enabled, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Row<N, W> s;
  load_row<N, W>(in, r, s);
  if (s.result == ONGOING && enabled[r]) {   // else the row comes back frozen
    step_row<N, W>(s, action[r]);
    s.result = result_of<N, W>(s);
  }
  store_row<N, W>(out, r, s);
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
