// Large-tree wave kernels (pools up to 140,000 nodes, no recycling), written
// for Hopper (sm_90a).
//
// Replaces tak_tpu/mcts/pallas_hbm.py:
//   build_descend_wave_hbm (:324)        -> tak_descend_wave_hbm
//   build_expand_backup_wave_hbm (:648)  -> tak_expand_backup_wave_hbm
// The plain PyTorch versions (tak_tpu_torch/mcts/tree_kernels_hbm.py) state
// the semantics; this file must agree with them bit for bit.
//
// The TPU kernels fetch six edge rows per tree level by DMA, keep a 512-row
// cache in VMEM and write rows back synchronously, because VMEM cannot hold
// the edge tier.  Here the whole tree lives in global memory and the L2
// caches what a walk touches, so none of that exists: a level is six
// coalesced row loads (the pick needs five; edge_child rides along so that
// the chosen slot's child needs no dependent second read).  The recycling fields (node_n, node_virt, child_count)
// are not arguments of these kernels.
//
// Layout: one thread block per game (the single-game Player launches one
// block).  Descents within a game are sequential by definition.
//   descend: all 1024 threads score the A root actions and reduce to the
//     last maximum; warp 0 walks, each lane scoring K/32 slots of the row
//     (4 at K=128) and carrying the slot's child, action and visit total
//     through the warp argmax, so a level costs one round of loads; lane 0
//     makes every scalar update, and __syncwarp()/__syncthreads() order its
//     writes before the next reads.
//   expand+backup: the block installs a new leaf's row (one slot per thread
//     and array), then thread 0 walks to the root.  The float adds into
//     edge_w/root_w keep the leaf order v = 0..V-1.
//
// What bounds them: latency.  A descent is a chain of dependent loads (one
// per level) behind a block-wide reduction, and the launch occupies one SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast-math: logf/sqrtf/division must round as PyTorch's own CUDA ops do).
// Index arithmetic is size_t: B*M*K reaches 2^24 per game.

#include "tree_common.cuh"

#define DESCEND_THREADS 1024
#define BACKUP_THREADS 128

struct Dims {
  int B, M, K, A, V;
  float base, init;
};

struct DescendTree {
  int* parent; int* parent_slot; int* parent_action;
  const unsigned char* expanded;
  const int* edge_action; const float* edge_prior; int* edge_child;
  const int* edge_n; int* edge_virt; const float* edge_w;
  const float* root_prior; int* root_child; const unsigned char* root_legal;
  const int* root_n; int* root_virt; const float* root_w;
  const int* n0; int* virt0; int* next_free;
};

struct BackupTree {
  const int* parent; const int* parent_slot; const int* parent_action;
  unsigned char* expanded;
  int* edge_action; float* edge_prior; int* edge_child;
  int* edge_n; int* edge_virt; float* edge_w;
  int* root_n; int* root_virt; float* root_w;
  int* n0; int* virt0;
};

struct PendingWave {
  const int* leaves; const float* topk_vals; const int* topk_aidx;
  const int* results; const float* values; const int* to_move;
};

// Broadcast lane `src`'s value to the warp.
__device__ __forceinline__ int warp_pick(int x, int src) {
  return __shfl_sync(0xffffffffu, x, src);
}

__global__ void __launch_bounds__(DESCEND_THREADS)
descend_hbm_kernel(DescendTree t, Dims p, int* leaves_out,
                   unsigned char* created_out) {
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int sh_nf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x;
  const size_t m = (size_t)g * p.M, mk = m * p.K, ao = (size_t)g * p.A;
  int* parent = t.parent + m;
  int* parent_slot = t.parent_slot + m;
  int* parent_action = t.parent_action + m;
  const unsigned char* expanded = t.expanded + m;
  const int* edge_action = t.edge_action + mk;
  const float* edge_prior = t.edge_prior + mk;
  int* edge_child = t.edge_child + mk;
  const int* edge_n = t.edge_n + mk;
  int* edge_virt = t.edge_virt + mk;
  const float* edge_w = t.edge_w + mk;
  const float* root_prior = t.root_prior + ao;
  int* root_child = t.root_child + ao;
  const unsigned char* root_legal = t.root_legal + ao;
  const int* root_n = t.root_n + ao;
  int* root_virt = t.root_virt + ao;
  const float* root_w = t.root_w + ao;

  const int n0 = t.n0[g];
  int virt0 = t.virt0[g];
  int nf = t.next_free[g];
  for (int v = 0; v < p.V; ++v) {
    // ---- root selection: dense PUCT over the full action space ----
    const float n0f = (float)(n0 + virt0);
    const float cp = c_puct(n0f, p.base, p.init);
    const float sq = sqrtf(n0f);
    float best_s = -INFINITY;
    int best_i = -1;
    for (int a = tid; a < p.A; a += DESCEND_THREADS) {
      const int rv = root_virt[a], rn = root_n[a];
      const float tot = (float)(rn + rv);
      const float q = tot > 0.0f ? (root_w[a] - (float)rv) / fmaxf(tot, 1.0f)
                                 : 0.0f;
      const float u = cp * root_prior[a] * sq / (1.0f + tot);
      const float sc = root_legal[a] ? (q + u) + 0.0f : -INFINITY;
      if (sc >= best_s) { best_s = sc; best_i = a; }
    }
    const int a0 = block_argmax_last(best_s, best_i, red_s, red_i);

    if (warp == 0) {
      const int c0 = root_child[a0];
      int nv = root_n[a0] + root_virt[a0];
      const bool room0 = nf < p.M;
      const bool create0 = c0 == NONE && room0;
      __syncwarp();   // every lane has read the root entry before lane 0 marks it
      if (lane == 0) {
        // no mark on a rootward create that finds the pool full
        if (c0 != NONE || room0) root_virt[a0] += 1;
        if (create0) {
          root_child[a0] = nf;
          parent[nf] = 0;
          parent_slot[nf] = NONE;
          parent_action[nf] = a0;
        }
      }
      __syncwarp();
      int leaf_v = create0 ? nf : 0;
      bool created_v = create0;
      int cur = create0 ? NONE : c0;
      if (create0) nf += 1;

      // ---- walk down the tree until a leaf resolves ----
      while (cur != NONE) {
        const bool exp = expanded[cur] != 0;
        const size_t row = (size_t)cur * p.K;
        const float npf = (float)nv;
        const float cpe = c_puct(npf, p.base, p.init);
        const float sqe = sqrtf(npf);
        float bs = -INFINITY;
        int bi = -1, b_child = NONE, b_action = NONE, b_tot = 0;
        for (int k = lane; k < p.K; k += 32) {
          const int ev = edge_virt[row + k], en = edge_n[row + k];
          const int ea = edge_action[row + k], ec = edge_child[row + k];
          const float tot = (float)(en + ev);
          const float q = tot > 0.0f
                              ? (edge_w[row + k] - (float)ev) / fmaxf(tot, 1.0f)
                              : 0.0f;
          const float u = cpe * edge_prior[row + k] * sqe / (1.0f + tot);
          const float sc = ea != NONE ? q + u : -INFINITY;
          if (sc >= bs) {
            bs = sc; bi = k; b_action = ea; b_tot = en + ev; b_child = ec;
          }
        }
        warp_argmax_last(bs, bi);
        const int slot = bi;
        const int owner = slot & 31;   // slot k is scored by lane k % 32
        const int child = warp_pick(b_child, owner);
        const int action = warp_pick(b_action, owner);
        const int cnv = warp_pick(b_tot, owner);
        const size_t e = row + slot;
        const bool want = exp && child == NONE;
        const bool ok = want && nf < p.M;
        if (lane == 0) {
          if (exp) edge_virt[e] += 1;
          if (ok) {
            edge_child[e] = nf;
            parent[nf] = cur;
            parent_slot[nf] = slot;
            parent_action[nf] = action;
          }
        }
        __syncwarp();
        const bool stopping = !exp || want;
        if (stopping) leaf_v = ok ? nf : cur;
        if (ok) { created_v = true; nf += 1; }
        if (!stopping) nv = cnv;
        cur = stopping ? NONE : child;
      }
      if (lane == 0) {
        leaves_out[(size_t)g * p.V + v] = leaf_v;
        created_out[(size_t)g * p.V + v] = created_v ? 1 : 0;
        sh_nf = nf;
      }
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

__global__ void __launch_bounds__(BACKUP_THREADS)
expand_backup_hbm_kernel(BackupTree t, PendingWave pd, Dims p) {
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const size_t m = (size_t)g * p.M, mk = m * p.K, ao = (size_t)g * p.A;
  const int* parent = t.parent + m;
  const int* parent_slot = t.parent_slot + m;
  const int* parent_action = t.parent_action + m;
  unsigned char* expanded = t.expanded + m;
  int* edge_action = t.edge_action + mk;
  float* edge_prior = t.edge_prior + mk;
  int* edge_child = t.edge_child + mk;
  int* edge_n = t.edge_n + mk;
  int* edge_virt = t.edge_virt + mk;
  float* edge_w = t.edge_w + mk;
  int* root_n = t.root_n + ao;
  int* root_virt = t.root_virt + ao;
  float* root_w = t.root_w + ao;

  int n0 = t.n0[g], virt0 = t.virt0[g];
  for (int v = 0; v < p.V; ++v) {
    const size_t pv = (size_t)g * p.V + v;
    const int leaf = pd.leaves[pv];
    const int res = pd.results[pv];
    const bool was_exp = expanded[leaf] != 0;
    __syncthreads();   // every thread has read the flag before it is set
    // ---- expansion: install the leaf's top-K prior row ----
    if (res == ONGOING && leaf != 0 && !was_exp) {
      const size_t row = (size_t)leaf * p.K;
      const size_t src = pv * p.K;
      for (int k = tid; k < p.K; k += BACKUP_THREADS) {
        const float va = pd.topk_vals[src + k];
        const bool okm = va >= 0.0f;
        edge_action[row + k] = okm ? pd.topk_aidx[src + k] : NONE;
        edge_child[row + k] = NONE;
        edge_prior[row + k] = okm ? va : 0.0f;
        edge_n[row + k] = 0;
        edge_virt[row + k] = 0;
        edge_w[row + k] = 0.0f;
      }
      if (tid == 0) expanded[leaf] = 1;
    }
    // ---- sign-alternating walk to the root (one thread) ----
    if (tid == 0) {
      const int winner = (res == 1 || res == 3) ? 0
                         : ((res == 2 || res == 4) ? 1 : -1);
      const float term = winner < 0 ? 0.0f
                         : (pd.to_move[pv] == winner ? 1.0f : -1.0f);
      const float val = res != ONGOING ? term : pd.values[pv];
      float sign = -1.0f;
      int cur = leaf;
      while (cur != NONE) {
        const int par = parent[cur], s = parent_slot[cur];
        const float add = sign * val;
        if (par == 0 && s == NONE) {
          const int a = parent_action[cur];
          if (a >= 0 && a < p.A) {
            root_n[a] += 1;
            root_virt[a] -= 1;
            root_w[a] = root_w[a] + add;
          }
        } else if (par != NONE && s >= 0 && s < p.K) {
          const size_t e = (size_t)par * p.K + s;
          edge_n[e] += 1;
          edge_virt[e] -= 1;
          edge_w[e] = edge_w[e] + add;
        }
        if (cur == 0) { n0 += 1; virt0 -= 1; }
        cur = par;
        sign = -sign;
      }
    }
    __syncthreads();   // leaf v is wholly applied before leaf v+1 starts
  }
  if (tid == 0) { t.n0[g] = n0; t.virt0[g] = virt0; }
}

extern "C" int tak_descend_wave_hbm(
    int B, int M, int K, int A, int V, float base, float init,
    void* parent, void* parent_slot, void* parent_action, void* expanded,
    void* edge_action, void* edge_prior, void* edge_child, void* edge_n,
    void* edge_virt, void* edge_w, void* root_prior, void* root_child,
    void* root_legal, void* root_n, void* root_virt, void* root_w, void* n0,
    void* virt0, void* next_free, void* leaves, void* created, void* stream) {
  DescendTree t;
  t.parent = (int*)parent; t.parent_slot = (int*)parent_slot;
  t.parent_action = (int*)parent_action;
  t.expanded = (const unsigned char*)expanded;
  t.edge_action = (const int*)edge_action;
  t.edge_prior = (const float*)edge_prior; t.edge_child = (int*)edge_child;
  t.edge_n = (const int*)edge_n; t.edge_virt = (int*)edge_virt;
  t.edge_w = (const float*)edge_w;
  t.root_prior = (const float*)root_prior; t.root_child = (int*)root_child;
  t.root_legal = (const unsigned char*)root_legal;
  t.root_n = (const int*)root_n; t.root_virt = (int*)root_virt;
  t.root_w = (const float*)root_w;
  t.n0 = (const int*)n0; t.virt0 = (int*)virt0; t.next_free = (int*)next_free;
  const Dims p = {B, M, K, A, V, base, init};
  descend_hbm_kernel<<<B, DESCEND_THREADS, 0, (cudaStream_t)stream>>>(
      t, p, (int*)leaves, (unsigned char*)created);
  return (int)cudaGetLastError();
}

extern "C" int tak_expand_backup_wave_hbm(
    int B, int M, int K, int A, int V,
    void* parent, void* parent_slot, void* parent_action, void* expanded,
    void* edge_action, void* edge_prior, void* edge_child, void* edge_n,
    void* edge_virt, void* edge_w, void* root_n, void* root_virt,
    void* root_w, void* n0, void* virt0,
    void* leaves, void* topk_vals, void* topk_aidx, void* results,
    void* values, void* to_move, void* stream) {
  BackupTree t;
  t.parent = (const int*)parent; t.parent_slot = (const int*)parent_slot;
  t.parent_action = (const int*)parent_action;
  t.expanded = (unsigned char*)expanded;
  t.edge_action = (int*)edge_action; t.edge_prior = (float*)edge_prior;
  t.edge_child = (int*)edge_child; t.edge_n = (int*)edge_n;
  t.edge_virt = (int*)edge_virt; t.edge_w = (float*)edge_w;
  t.root_n = (int*)root_n; t.root_virt = (int*)root_virt;
  t.root_w = (float*)root_w;
  t.n0 = (int*)n0; t.virt0 = (int*)virt0;
  PendingWave pd;
  pd.leaves = (const int*)leaves; pd.topk_vals = (const float*)topk_vals;
  pd.topk_aidx = (const int*)topk_aidx; pd.results = (const int*)results;
  pd.values = (const float*)values; pd.to_move = (const int*)to_move;
  const Dims p = {B, M, K, A, V, 0.0f, 0.0f};
  expand_backup_hbm_kernel<<<B, BACKUP_THREADS, 0, (cudaStream_t)stream>>>(
      t, pd, p);
  return (int)cudaGetLastError();
}
