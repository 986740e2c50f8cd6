// The squeeze-and-excitation epilogue of a residual block in the folded
// inference model, for Hopper (sm_90a): Leela Chess Zero's SE unit
// (lczero-training tf/tfprocess.py, squeeze_excitation and
// ApplySqueezeExcitation) in one launch.
//
// Replaces no TPU kernel: the JAX package's ResNet has no SE unit.  Added
// for the 20 x 256 SE-ResNet at 8x8, where the epilogue done as separate
// PyTorch ops is about eight passes over a 268 MB activation a block at an
// 8,192-row wave.  The plain PyTorch version
// (tak_tpu_torch/model/squeeze_excite.py: se_epilogue_plain) states the
// semantics: for a row's y (the block's folded second convolution) and x
// (the block's input), both [H*W, C] bf16 channels-last,
//   m = mean over squares of y          (float32)
//   s = relu(W1 m + b1)                 W1 [S, C], float32
//   e = W2 s + b2                       W2 [2C, S], float32
//   out = relu(sigmoid(e[:C]) * y + e[C:] + x), rounded once to bf16.
//
// What bounds it: bytes.  A row reads y and x and writes out, 3 * H*W*C * 2
// bytes (98,304 B at 8x8 x 256), against about 5 H*W*C + 6 C*S operations;
// at 3.35 TB/s that is 29 ns a row.  Design:
//   * persistent blocks of 256 threads, two an SM, each walking rows
//     blockIdx.x, blockIdx.x + gridDim.x, ...; the dense weights (96 KB at
//     C=256, S=32) are read once per block into shared memory, transposed
//     so that the dense layers' reads are free of bank conflicts;
//   * a thread holds the same 8 channels (one 16-byte load) in every
//     vector it takes of a row, at most 8 vectors: y and x stay in
//     registers between the load and the store, and x is loaded right
//     after y so that its loads are in flight while the block reduces the
//     means and runs both dense layers;
//   * the channel sums are combined over the block in a fixed order, the
//     dense layers' sums too: every run gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast-math: the epilogue's products and sums round as the plain version's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXV = 8;            // 8-channel vectors a thread holds of a row
constexpr int SLOTS_FLOATS = 2048; // the channel sums' slots: THREADS * 8

__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// rounded to the nearest, ties to even, as torch's .to(bfloat16)
__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

__global__ void __launch_bounds__(THREADS, 2) tak_se_epilogue_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, long long rows, int HW, int C, int S) {
  extern __shared__ float sm[];
  float* w1t = sm;                    // [C][S]
  float* w2t = w1t + C * S;           // [S][2C]
  float* bb1 = w2t + 2 * C * S;       // [S]
  float* bb2 = bb1 + S;               // [2C]
  float* slots = bb2 + 2 * C;         // channel sums [THREADS / G][C], then
                                      // the first layer's parts [P][S]
  float* mean = slots + SLOTS_FLOATS; // [C]
  float* hid = mean + C;              // [S]
  float* gate = hid + S;              // [2C]: sigmoid(gamma), then beta
  const int t = threadIdx.x;
  const int C2 = 2 * C;
  for (int i = t; i < C * S; i += THREADS)        // w1 [S][C]
    w1t[(i % C) * S + i / C] = w1[i];
  for (int i = t; i < C2 * S; i += THREADS)       // w2 [2C][S]
    w2t[(i % S) * C2 + i / S] = w2[i];
  for (int i = t; i < S; i += THREADS) bb1[i] = b1[i];
  for (int i = t; i < C2; i += THREADS) bb2[i] = b2[i];
  __syncthreads();

  const int G = C / 8;                // channel groups of 8
  const int cg = t % G;               // this thread's group in every vector
  const int slot = t / G;
  const int nslots = THREADS / G;
  const int nvec = HW * G;            // vectors a row
  const int P = THREADS / S;          // parts of the first layer's sums
  const int CP = C / P;               // channels a part
  const float hw = (float)HW;

  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const uint4* yr = reinterpret_cast<const uint4*>(y + r * HW * C);
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * HW * C);
    uint4* outr = reinterpret_cast<uint4*>(out + r * HW * C);
    uint4 yv[MAXV], xv[MAXV];
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int v = t + j * THREADS;
      if (v < nvec) yv[j] = __ldg(yr + v);
    }
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int v = t + j * THREADS;
      if (v < nvec) xv[j] = __ldg(xr + v);
    }
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      if (t + j * THREADS < nvec) {
        float f[8];
        unpack8(yv[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += f[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) slots[slot * C + cg * 8 + e] = acc[e];
    __syncthreads();
    for (int c = t; c < C; c += THREADS) {
      float s = 0.0f;
      for (int q = 0; q < nslots; ++q) s += slots[q * C + c];
      mean[c] = s / hw;
    }
    __syncthreads();
    {  // the first layer: hidden unit t % S, channels of part t / S
      const int j = t % S, p = t / S;
      float s = 0.0f;
      for (int c = p * CP; c < (p + 1) * CP; ++c) s += w1t[c * S + j] * mean[c];
      slots[p * S + j] = s;
    }
    __syncthreads();
    for (int j = t; j < S; j += THREADS) {
      float s = 0.0f;
      for (int p = 0; p < P; ++p) s += slots[p * S + j];
      hid[j] = fmaxf(s + bb1[j], 0.0f);
    }
    __syncthreads();
    for (int k = t; k < C2; k += THREADS) {   // the second layer
      float s = 0.0f;
      for (int j = 0; j < S; ++j) s += w2t[j * C2 + k] * hid[j];
      s += bb2[k];
      gate[k] = k < C ? 1.0f / (1.0f + expf(-s)) : s;
    }
    __syncthreads();
    float g[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[e] = gate[cg * 8 + e];
      b[e] = gate[C + cg * 8 + e];
    }
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int v = t + j * THREADS;
      if (v < nvec) {
        float fy[8], fx[8], o[8];
        unpack8(yv[j], fy);
        unpack8(xv[j], fx);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaxf(g[e] * fy[e] + b[e] + fx[e], 0.0f);
        outr[v] = pack8(o);
      }
    }
    __syncthreads();   // the next row rewrites slots and gate
  }
}

size_t smem_bytes(int C, int S) {
  return sizeof(float) * ((size_t)3 * C * S + S + 2 * C + SLOTS_FLOATS + C + S
                          + 2 * C);
}

}  // namespace

// rows, H*W, C, S, the card's SM count, y, x, w1 [S, C], b1 [S],
// w2 [2C, S], b2 [2C], out, stream.  y, x and out are [rows, H*W, C] bf16
// (channels-last), 16-byte aligned.
extern "C" int tak_se_epilogue(long long rows, int HW, int C, int S, int sms,
                               const void* y, const void* x, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* out, void* stream) {
  if (rows <= 0 || HW <= 0 || C <= 0 || C % 8 != 0 || THREADS % (C / 8) != 0
      || HW * (C / 8) > THREADS * MAXV || S <= 0 || THREADS % S != 0
      || C % (THREADS / S) != 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, S);
  // the limit and the blocks an SM holds, asked once per shared memory size
  static size_t known_smem = 0;
  static int per_sm = 0;
  if (smem != known_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        tak_se_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tak_se_epilogue_kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    known_smem = smem;
  }
  const long long most = (long long)per_sm * sms;
  const int grid = (int)(rows < most ? rows : most);
  tak_se_epilogue_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const __nv_bfloat16*)x, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2,
      (__nv_bfloat16*)out, rows, HW, C, S);
  return (int)cudaGetLastError();
}
