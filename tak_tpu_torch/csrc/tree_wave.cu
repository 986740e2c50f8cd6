// Tree wave kernels for the batched PUCT search, written for Hopper (sm_90a).
//
// Replaces tak_tpu/mcts/pallas_ops.py:
//   build_backup_descend_wave (:1118)  -> tak_backup_descend_wave (valid=1)
//   build_descend_wave (:1284)         -> tak_backup_descend_wave (valid=0)
//   build_expand_backup_wave (:637)    -> tak_expand_backup_wave
// The plain PyTorch version (tak_tpu_torch/mcts/tree_kernels.py) states the
// semantics; this file must agree with it bit for bit.
//
// Layout: one thread block per game; the tree tensors live in global memory
// (B x M x K edge tier, B x A root tier, B x M node tier) and are updated in
// place.  Descents are sequential within a game: each descent computes the
// victim pair and the root PUCT argmax with the whole block, then warp 0 walks
// the tree (a warp-wide argmax over the K edge slots) and makes every scalar
// update.  Backups run in warp 0.  Every lane of warp 0 carries the same
// scalar state; lane 0 alone writes, and __syncwarp() orders its writes before
// the warp's next reads.
//
// What bounds it: the sequential chain of block-wide reductions and dependent
// loads per descent, with one block per game (32 blocks on 132 SMs).  Making
// games or descents overlap is the first thing a faster version attacks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast-math: logf/sqrtf/division must round as PyTorch's own CUDA ops do).

#include "tree_common.cuh"

#define INT_INF (1 << 30)
#define THREADS 512

struct Tree {
  int* parent; int* parent_slot; int* parent_action; unsigned char* expanded;
  int* node_n; int* node_virt; int* child_count;
  int* edge_action; float* edge_prior; int* edge_child; int* edge_n;
  int* edge_virt; float* edge_w;
  float* root_prior; int* root_child; const unsigned char* root_legal;
  int* root_n; int* root_virt; float* root_w;
  int* n0; int* virt0; int* next_free;
};

struct Pending {
  const int* leaves; const float* topk_vals; const int* topk_aidx;
  const int* results; const float* values; const int* to_move;
};

struct Params {
  int B, M, K, A, V, recycle, PK;
  float base, init;
};

// Per-game views of the tree.
struct Game {
  int* parent; int* parent_slot; int* parent_action; unsigned char* expanded;
  int* node_n; int* node_virt; int* child_count;
  int* edge_action; float* edge_prior; int* edge_child; int* edge_n;
  int* edge_virt; float* edge_w;
  float* root_prior; int* root_child; const unsigned char* root_legal;
  int* root_n; int* root_virt; float* root_w;
};

__device__ __forceinline__ Game game_view(const Tree& t, const Params& p, int g) {
  const size_t m = (size_t)g * p.M, mk = (size_t)g * p.M * p.K,
               a = (size_t)g * p.A;
  Game v;
  v.parent = t.parent + m; v.parent_slot = t.parent_slot + m;
  v.parent_action = t.parent_action + m; v.expanded = t.expanded + m;
  v.node_n = t.node_n + m; v.node_virt = t.node_virt + m;
  v.child_count = t.child_count + m;
  v.edge_action = t.edge_action + mk; v.edge_prior = t.edge_prior + mk;
  v.edge_child = t.edge_child + mk; v.edge_n = t.edge_n + mk;
  v.edge_virt = t.edge_virt + mk; v.edge_w = t.edge_w + mk;
  v.root_prior = t.root_prior + a; v.root_child = t.root_child + a;
  v.root_legal = t.root_legal + a; v.root_n = t.root_n + a;
  v.root_virt = t.root_virt + a; v.root_w = t.root_w + a;
  return v;
}

__device__ int block_min(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < nwarps ? red[lane] : INT_INF;
    for (int off = 16; off > 0; off >>= 1)
      x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

struct VictimPair { int v1, v2; bool have1, have2; };

// Slot allocation in warp 0 (all lanes call it with the same arguments).
__device__ void alloc(const Game& G, const Params& p, const VictimPair& vp,
                      bool want, int& nf, int cur, int& slot, bool& ok) {
  const int lane = threadIdx.x & 31;
  if (!p.recycle) {
    ok = want && nf < p.M;
    slot = nf;
    if (ok) nf += 1;
    return;
  }
  const bool fresh = nf < p.M;
  const bool use2 = vp.v1 == cur;
  const int victim = use2 ? vp.v2 : vp.v1;
  const bool have = use2 ? vp.have2 : vp.have1;
  if (want && !fresh && have) {
    const int pv = G.parent[victim], sv = G.parent_slot[victim];
    if (lane == 0) {
      if (pv == 0 && sv == NONE) {
        const int av = G.parent_action[victim];
        if (av >= 0 && av < p.A) G.root_child[av] = NONE;
      } else if (pv >= 0 && sv >= 0 && sv < p.K) {
        G.edge_child[(size_t)pv * p.K + sv] = NONE;
      }
      if (pv >= 0) G.child_count[pv] -= 1;
      G.expanded[victim] = 0;
      G.node_n[victim] = 0;
    }
    __syncwarp();
  }
  slot = fresh ? nf : victim;
  ok = want && (fresh || have);
  if (want && fresh) nf += 1;
}

// Phase 1: expansions and value backups of the pending wave (warp 0).
__device__ void backup_phase(const Tree& t, const Pending& pd, const Params& p,
                             int g) {
  const int lane = threadIdx.x & 31;
  const Game G = game_view(t, p, g);
  int n0 = t.n0[g], virt0 = t.virt0[g];
  for (int v = 0; v < p.V; ++v) {
    const int pv = g * p.V + v;
    int cur = pd.leaves[pv];
    const int res = pd.results[pv];
    const int winner = (res == 1 || res == 3) ? 0
                       : ((res == 2 || res == 4) ? 1 : -1);
    const float term = winner < 0 ? 0.0f
                       : (pd.to_move[pv] == winner ? 1.0f : -1.0f);
    const float val = res != ONGOING ? term : pd.values[pv];
    const bool was_exp = G.expanded[cur] != 0;
    __syncwarp();
    if (p.recycle && lane == 0) G.node_virt[cur] -= 1;
    if (res == ONGOING && cur != 0 && !was_exp) {
      const size_t row = (size_t)cur * p.K;
      const size_t src = (size_t)pv * p.K;
      for (int k = lane; k < p.K; k += 32) {
        const float va = pd.topk_vals[src + k];
        const bool okm = va >= 0.0f;
        G.edge_action[row + k] = okm ? pd.topk_aidx[src + k] : NONE;
        G.edge_child[row + k] = NONE;
        G.edge_prior[row + k] = okm ? va : 0.0f;
        G.edge_n[row + k] = 0;
        G.edge_virt[row + k] = 0;
        G.edge_w[row + k] = 0.0f;
      }
      if (lane == 0) G.expanded[cur] = 1;
    }
    __syncwarp();
    float sign = -1.0f;
    while (cur != NONE) {
      const int par = G.parent[cur], s = G.parent_slot[cur];
      const bool is_root_edge = par == 0 && s == NONE;
      const bool is_edge = par != NONE && !is_root_edge;
      const float add = sign * val;
      if (lane == 0) {
        if (is_root_edge) {
          const int a = G.parent_action[cur];
          if (a >= 0 && a < p.A) {
            G.root_n[a] += 1;
            G.root_virt[a] -= 1;
            G.root_w[a] = G.root_w[a] + add;
          }
        }
        if (is_edge && s >= 0 && s < p.K) {
          const size_t e = (size_t)par * p.K + s;
          G.edge_n[e] += 1;
          G.edge_virt[e] -= 1;
          G.edge_w[e] = G.edge_w[e] + add;
        }
      }
      if (cur == 0) { n0 += 1; virt0 -= 1; }
      cur = par;
      sign = -sign;
      __syncwarp();
    }
  }
  if (lane == 0) { t.n0[g] = n0; t.virt0[g] = virt0; }
  __syncwarp();
}

// Phase 2: V sequential virtual-loss PUCT descents (whole block).
__device__ void descend_phase(const Tree& t, const Params& p, int g,
                              int* leaves_out, unsigned char* created_out) {
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int sh_nf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Game G = game_view(t, p, g);
  const int n0 = t.n0[g];
  int virt0 = t.virt0[g];
  int nf = t.next_free[g];
  for (int v = 0; v < p.V; ++v) {
    // ---- victim pair: min (clamped node_n, index) over candidates ----
    VictimPair vp = {0, 0, false, false};
    if (p.recycle) {
      const int clamp_n = INT_INF / p.PK - 1;
      int best = INT_INF;
      for (int i = tid; i < p.M; i += blockDim.x) {
        if (i > 0 && G.child_count[i] == 0 && G.node_virt[i] == 0)
          best = min(best, min(G.node_n[i], clamp_n) * p.PK + i);
      }
      const int m1 = block_min(best, red_i);
      vp.v1 = m1 % p.PK;
      vp.have1 = m1 < INT_INF;
      best = INT_INF;
      for (int i = tid; i < p.M; i += blockDim.x) {
        if (i > 0 && i != vp.v1 && G.child_count[i] == 0 &&
            G.node_virt[i] == 0)
          best = min(best, min(G.node_n[i], clamp_n) * p.PK + i);
      }
      const int m2 = block_min(best, red_i);
      vp.v2 = m2 % p.PK;
      vp.have2 = m2 < INT_INF;
    }

    // ---- root selection: dense PUCT over the full action space ----
    const float n0f = (float)(n0 + virt0);
    const float cp = c_puct(n0f, p.base, p.init);
    const float sq = sqrtf(n0f);
    float best_s = -INFINITY;
    int best_i = -1;
    for (int a = tid; a < p.A; a += blockDim.x) {
      const int rv = G.root_virt[a], rn = G.root_n[a];
      const float tot = (float)(rn + rv);
      const float q = tot > 0.0f ? (G.root_w[a] - (float)rv) / fmaxf(tot, 1.0f)
                                 : 0.0f;
      const float u = cp * G.root_prior[a] * sq / (1.0f + tot);
      const float sc = G.root_legal[a] ? (q + u) + 0.0f : -INFINITY;
      if (sc >= best_s) { best_s = sc; best_i = a; }
    }
    const int a0 = block_argmax_last(best_s, best_i, red_s, red_i);

    if (warp == 0) {
      const int c0 = G.root_child[a0];
      const int rn_a0 = G.root_n[a0];
      const int nv0 = rn_a0 + G.root_virt[a0];
      int slot0;
      bool ok0;
      alloc(G, p, vp, c0 == NONE, nf, 0, slot0, ok0);
      const bool proceed0 = c0 != NONE || ok0;
      if (lane == 0) {
        if (proceed0) G.root_virt[a0] += 1;
        if (ok0) {
          G.root_child[a0] = slot0;
          G.parent[slot0] = 0;
          G.parent_slot[slot0] = NONE;
          G.expanded[slot0] = 0;
          G.parent_action[slot0] = a0;
          if (p.recycle) {
            G.child_count[0] += 1;
            G.node_n[slot0] = rn_a0;
          }
        }
      }
      __syncwarp();
      int leaf_v = ok0 ? slot0 : 0;
      bool created_v = ok0;
      int cur = ok0 ? NONE : c0;
      int nv = nv0;

      // ---- walk down the tree until a leaf resolves ----
      while (cur != NONE) {
        const bool exp = G.expanded[cur] != 0;
        const size_t row = (size_t)cur * p.K;
        const float npf = (float)nv;
        const float cpe = c_puct(npf, p.base, p.init);
        const float sqe = sqrtf(npf);
        float bs = -INFINITY;
        int bi = -1;
        for (int k = lane; k < p.K; k += 32) {
          const int ev = G.edge_virt[row + k], en = G.edge_n[row + k];
          const float tot = (float)(en + ev);
          const float q = tot > 0.0f
                              ? (G.edge_w[row + k] - (float)ev) / fmaxf(tot, 1.0f)
                              : 0.0f;
          const float u = cpe * G.edge_prior[row + k] * sqe / (1.0f + tot);
          const float sc = G.edge_action[row + k] != NONE ? q + u : -INFINITY;
          if (sc >= bs) { bs = sc; bi = k; }
        }
        warp_argmax_last(bs, bi);
        const int slot = bi;
        const size_t e = row + slot;
        const int child = G.edge_child[e];
        const int action = G.edge_action[e];
        const int en_s = G.edge_n[e];
        const int cnv = en_s + G.edge_virt[e];
        const bool want = exp && child == NONE;
        int slot_c;
        bool ok_c;
        alloc(G, p, vp, want, nf, cur, slot_c, ok_c);
        if (lane == 0) {
          if (exp) G.edge_virt[e] += 1;
          if (ok_c) {
            G.edge_child[e] = slot_c;
            G.parent[slot_c] = cur;
            G.parent_slot[slot_c] = slot;
            G.expanded[slot_c] = 0;
            G.parent_action[slot_c] = action;
            if (p.recycle) {
              G.child_count[cur] += 1;
              G.node_n[slot_c] = en_s;
            }
          }
        }
        __syncwarp();
        const bool stopping = !exp || want;
        if (stopping) leaf_v = ok_c ? slot_c : cur;
        if (ok_c) created_v = true;
        if (!stopping) nv = cnv;
        cur = stopping ? NONE : child;
      }
      if (lane == 0) {
        if (p.recycle) G.node_virt[leaf_v] += 1;
        leaves_out[g * p.V + v] = leaf_v;
        created_out[g * p.V + v] = created_v ? 1 : 0;
        sh_nf = nf;
      }
      __syncwarp();
    }
    __syncthreads();
    nf = sh_nf;
    virt0 += 1;
  }
  if (tid == 0) {
    t.virt0[g] = virt0;
    t.next_free[g] = nf;
  }
}

__global__ void __launch_bounds__(THREADS)
backup_descend_kernel(Tree t, Pending pd, Params p, int valid,
                      int* leaves_out, unsigned char* created_out) {
  const int g = blockIdx.x;
  if (valid && threadIdx.x < 32) backup_phase(t, pd, p, g);
  __syncthreads();
  descend_phase(t, p, g, leaves_out, created_out);
}

__global__ void expand_backup_kernel(Tree t, Pending pd, Params p) {
  backup_phase(t, pd, p, blockIdx.x);
}

static void fill(Tree& t, Pending& pd, void** a) {
  t.parent = (int*)a[0]; t.parent_slot = (int*)a[1];
  t.parent_action = (int*)a[2]; t.expanded = (unsigned char*)a[3];
  t.node_n = (int*)a[4]; t.node_virt = (int*)a[5]; t.child_count = (int*)a[6];
  t.edge_action = (int*)a[7]; t.edge_prior = (float*)a[8];
  t.edge_child = (int*)a[9]; t.edge_n = (int*)a[10]; t.edge_virt = (int*)a[11];
  t.edge_w = (float*)a[12];
  t.root_prior = (float*)a[13]; t.root_child = (int*)a[14];
  t.root_legal = (const unsigned char*)a[15]; t.root_n = (int*)a[16];
  t.root_virt = (int*)a[17]; t.root_w = (float*)a[18];
  t.n0 = (int*)a[19]; t.virt0 = (int*)a[20]; t.next_free = (int*)a[21];
  pd.leaves = (const int*)a[22]; pd.topk_vals = (const float*)a[23];
  pd.topk_aidx = (const int*)a[24]; pd.results = (const int*)a[25];
  pd.values = (const float*)a[26]; pd.to_move = (const int*)a[27];
}

#define TREE_ARGS                                                             \
  void *a0, void *a1, void *a2, void *a3, void *a4, void *a5, void *a6,       \
      void *a7, void *a8, void *a9, void *a10, void *a11, void *a12,          \
      void *a13, void *a14, void *a15, void *a16, void *a17, void *a18,       \
      void *a19, void *a20, void *a21, void *a22, void *a23, void *a24,       \
      void *a25, void *a26, void *a27
#define TREE_ARRAY                                                            \
  {a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11, a12, a13, a14,           \
   a15, a16, a17, a18, a19, a20, a21, a22, a23, a24, a25, a26, a27}

static Params make_params(int B, int M, int K, int A, int V, int recycle,
                          float base, float init) {
  Params p;
  p.B = B; p.M = M; p.K = K; p.A = A; p.V = V; p.recycle = recycle;
  p.PK = ((M + 127) / 128) * 128;
  p.base = base; p.init = init;
  return p;
}

extern "C" int tak_backup_descend_wave(int B, int M, int K, int A, int V,
                                       int recycle, float base, float init,
                                       int valid, TREE_ARGS, void* leaves,
                                       void* created, void* stream) {
  Tree t;
  Pending pd;
  void* a[28] = TREE_ARRAY;
  fill(t, pd, a);
  const Params p = make_params(B, M, K, A, V, recycle, base, init);
  backup_descend_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      t, pd, p, valid, (int*)leaves, (unsigned char*)created);
  return (int)cudaGetLastError();
}

extern "C" int tak_expand_backup_wave(int B, int M, int K, int A, int V,
                                      int recycle, float base, float init,
                                      int valid, TREE_ARGS, void* leaves,
                                      void* created, void* stream) {
  (void)valid; (void)leaves; (void)created;
  Tree t;
  Pending pd;
  void* a[28] = TREE_ARRAY;
  fill(t, pd, a);
  const Params p = make_params(B, M, K, A, V, recycle, base, init);
  expand_backup_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(t, pd, p);
  return (int)cudaGetLastError();
}
