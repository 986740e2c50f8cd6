// Device helpers shared by the tree wave kernels (tree_wave.cu for the
// pool tier, tree_wave_hbm.cu for the large-tree tier): the PUCT constant
// and score, the last-max argmax over a warp and over a block, named
// barriers, and the expand+backup of a wave (both tiers run the same one;
// the pool tier also unpins its leaves).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NONE (-1)
#define ONGOING 0
#define FULL 0xffffffffu

__device__ __forceinline__ float c_puct(float n, float base, float init) {
  return logf((1.0f + n + base) / base) + init;
}

// Keep (s2, i2) over (s1, i1) when larger, or equal with a larger index.
__device__ __forceinline__ void argmax_last_merge(float& s1, int& i1, float s2,
                                                  int i2) {
  if (s2 > s1 || (s2 == s1 && i2 > i1)) { s1 = s2; i1 = i2; }
}

__device__ __forceinline__ void warp_argmax_last(float& s, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(FULL, s, off);
    int i2 = __shfl_xor_sync(FULL, i, off);
    argmax_last_merge(s, i, s2, i2);
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Order-preserving map of a score to an unsigned key (-0 counts as +0, as a
// float comparison counts it).
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float q_term(int n, int virt, float w) {
  const float tot = (float)(n + virt);
  return tot > 0.0f ? (w - (float)virt) / fmaxf(tot, 1.0f) : 0.0f;
}

// One edge slot's score; keeps the last maximum of the slots seen so far.
// An unvisited slot (most of a row) needs no division: q is 0 and u's
// denominator is 1.  An empty slot's numerator is 1 and not the 0 its prior
// would give: written so, the large tier's level measured 12% faster.
struct Best {
  float s; int slot, child, action, n, virt;
};

__device__ __forceinline__ void score_slot(Best& b, int k, int ea, int ec,
                                           int en, int ev, float ep, float ew,
                                           float cpe, float sqe) {
  const bool used = ea != NONE;
  const float num = used ? cpe * ep * sqe : 1.0f;
  float sc;
  if (en + ev != 0) {
    const float tot = (float)(en + ev);
    const float q = tot > 0.0f ? (ew - (float)ev) / fmaxf(tot, 1.0f) : 0.0f;
    sc = q + num / (1.0f + tot);
  } else {
    sc = 0.0f + num;
  }
  if (!used) sc = -INFINITY;
  if (sc >= b.s) {
    b.s = sc; b.slot = k; b.child = ec; b.action = ea; b.n = en; b.virt = ev;
  }
}

// ---------------------------------------------------------------------------
// Expand + backup of one wave, one block per game
// ---------------------------------------------------------------------------

struct Dims {
  int B, M, K, A, V;
  float base, init;
};

struct BackupTree {
  const int* parent; const int* parent_slot; const int* parent_action;
  unsigned char* expanded;
  int* edge_action; float* edge_prior; int* edge_child;
  int* edge_n; int* edge_virt; float* edge_w;
  int* root_n; int* root_virt; float* root_w;
  int* n0; int* virt0;
  int* node_virt;   // the pool tier with recycling: unpin each leaf; else null
};

struct PendingWave {
  const int* leaves; const float* topk_vals; const int* topk_aidx;
  const int* results; const float* values; const int* to_move;
};

// Shared memory of backup_wave: per leaf PATH_CAP + 1 path codes (odd: no
// bank conflicts either way), then length, node to go on from, root visits
// seen, leaf, install flags (candidate, first), value; SORTED adds the
// leaves' offsets into the list of updates, and the list: SORT_CAP keys and
// values.
#define SORT_CAP 4096

__host__ __device__ constexpr size_t backup_paths_bytes(int path_cap, int V) {
  return sizeof(int) * (size_t)V * (path_cap + 1 + 8);
}

template <int PATH_CAP, bool SORTED = false>
__host__ __device__ constexpr size_t backup_smem_bytes(int V) {
  return SORTED ? (backup_paths_bytes(PATH_CAP, V) + 7) / 8 * 8
                      + (sizeof(unsigned long long) + sizeof(float)) * SORT_CAP
                : sizeof(int) * (size_t)V * (PATH_CAP + 1 + 7);
}

// One level of a backup: the read-modify-writes of an edge or a root action,
// the three loads first so that they share one round trip.
__device__ __forceinline__ void apply_edge(int* n, int* virt, float* w,
                                           size_t e, float add) {
  const int en = n[e], ev = virt[e];
  const float ew = w[e];
  n[e] = en + 1;
  virt[e] = ev - 1;
  w[e] = ew + add;
}

// Phase 2 of a SORTED backup_wave, every thread: returns false (having
// changed nothing) when the wave's updates exceed SORT_CAP.
__device__ bool sorted_apply(const BackupTree& t, const Dims& p, int g,
                             int* sh, int stride) {
  const int* path = sh;
  const int* s_len = path + (size_t)p.V * stride;
  const int* s_roots = s_len + 2 * p.V;
  const float* s_val = (const float*)(s_roots + 4 * p.V);
  int* s_off = (int*)(s_val + p.V);
  unsigned long long* keys = (unsigned long long*)(
      (char*)sh + (backup_paths_bytes(stride - 1, p.V) + 7) / 8 * 8);
  float* adds = (float*)(keys + SORT_CAP);
  __shared__ int s_total, s_rootsum;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
  // ---- each leaf's offset into the list of updates (warp 0) ----
  if (warp == 0) {
    const int per = (p.V + 31) / 32;
    const int lo = min(lane * per, p.V), hi = min(lo + per, p.V);
    int sum = 0, roots = 0;
    for (int v = lo; v < hi; ++v) { sum += s_len[v]; roots += s_roots[v]; }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += x;
    }
    int run = incl - sum;
    for (int v = lo; v < hi; ++v) { s_off[v] = run; run += s_len[v]; }
    roots = __reduce_add_sync(FULL, roots);
    if (lane == 31) s_total = incl;
    if (lane == 0) s_rootsum = roots;
  }
  __syncthreads();
  const int total = s_total;
  int P = 1;
  while (P < total) P <<= 1;
  if (P > SORT_CAP) return false;
  // ---- the updates: key (edge, leaf, level), edges after the root's A ----
  const unsigned long long none = ~0ull;
  for (int v = tid; v < p.V; v += nt) {
    const int* code = path + (size_t)v * stride;
    unsigned long long* out = keys + s_off[v];
    for (int d = 0; d < s_len[v]; ++d) {
      const int c = code[d];
      const unsigned hi = c >= 0 ? (unsigned)p.A + (unsigned)c
                                 : (unsigned)(-2 - c);
      out[d] = c == NONE ? none
                         : ((unsigned long long)hi << 32)
                               | (unsigned)(v << 6 | d);
    }
  }
  for (int i = total + tid; i < P; i += nt) keys[i] = none;
  __syncthreads();
  // ---- bitonic sort, ascending ----
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += nt) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < total; i += nt) {
    if (keys[i] == none) continue;
    const unsigned lo = (unsigned)keys[i];
    adds[i] = ((lo & 1) ? 1.0f : -1.0f) * s_val[lo >> 6];
  }
  __syncthreads();
  // ---- every edge at once: its adds in leaf order, in registers ----
  const size_t mk = (size_t)g * p.M * p.K, ao = (size_t)g * p.A;
  for (int i = tid; i < total; i += nt) {
    const unsigned long long key = keys[i];
    const unsigned hi = (unsigned)(key >> 32);
    if (key == none || (i > 0 && (unsigned)(keys[i - 1] >> 32) == hi))
      continue;
    const bool edge = hi >= (unsigned)p.A;
    const size_t e = edge ? mk + (hi - (unsigned)p.A) : ao + hi;
    int* n = edge ? t.edge_n : t.root_n;
    int* virt = edge ? t.edge_virt : t.root_virt;
    float* w = edge ? t.edge_w : t.root_w;
    const int en = n[e], ev = virt[e];
    float ew = w[e];
    // the edge's adds in leaf order, four loads a step
    int j = i;
    for (;;) {
      unsigned long long kk[4];
      float aa[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kk[u] = j + u < total ? keys[j + u] : none;
        aa[u] = j + u < total ? adds[j + u] : 0.0f;
      }
      bool same = true;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        same = same && (unsigned)(kk[u] >> 32) == hi;
        if (same) { ew = ew + aa[u]; ++j; }
      }
      if (!same) break;
    }
    n[e] = en + (j - i);
    virt[e] = ev - (j - i);
    w[e] = ew;
  }
  if (tid == 0) {
    t.n0[g] += s_rootsum;
    t.virt0[g] -= s_rootsum;
  }
  return true;
}

// Phase 1: one thread per leaf walks its parent chain, all leaves at once
// (all of a level's loads go out whether wanted or not: a branch that few
// lanes take costs the whole warp a round trip), and records the path (edge
// index or root action) in shared memory.  Then warps 1.. install the rows
// of the new leaves (a leaf that occurs twice takes the first occurrence's
// row) while warp 0 runs phase 2: the leaves in order v = 0..V-1, the lanes
// applying one path's levels together, each with its three loads before its
// three stores, so the float adds into edge_w and root_w keep the leaf order
// and a path costs one round trip.  A path longer than PATH_CAP levels is
// finished by one lane, serially.  If a path passes through an unexpanded
// node (never in a tree the descend kernels grew), rows are installed in
// leaf order by warp 0 instead, so the result is the plain version's on any
// input.  The unpins (recycling) are integer adds: their order does not
// show.
//
// SORTED (the pool tier's V=256 leaves in order would be 256 round trips):
// phase 2 applies every edge at once instead.  The path levels become one
// list of updates, sorted by (edge, leaf) in shared memory (a bitonic
// sort); the first update of each edge loads the edge once, adds the
// edge's values in leaf order in registers (so the float sum rounds as the
// plain version's) and stores it once.  A wave whose list exceeds SORT_CAP,
// or that installs in leaf order, takes phase 2 above.
//
// Every thread of the block calls this; `sh` holds
// backup_smem_bytes<PATH_CAP, SORTED>(V) bytes.
template <int PATH_CAP, bool SORTED = false>
__device__ void backup_wave(const BackupTree& t, const PendingWave& pd,
                            const Dims& p, int g, int* sh) {
  static_assert(!SORTED || PATH_CAP < 64, "a level is kept in six bits");
  constexpr int STRIDE = PATH_CAP + 1;
  int* path = sh;
  int* s_len = path + (size_t)p.V * STRIDE;
  int* s_next = s_len + p.V;
  int* s_roots = s_next + p.V;
  int* s_leaf = s_roots + p.V;
  int* s_cand = s_leaf + p.V;
  int* s_first = s_cand + p.V;
  float* s_val = (float*)(s_first + p.V);
  __shared__ int s_odd;   // a path passes through an unexpanded node
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
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
  const size_t pg = (size_t)g * p.V;
  // expansion: slot k of leaf v's top-K prior row
  auto install = [&](int v, int k) {
    const size_t dst = (size_t)s_leaf[v] * p.K + k;
    const size_t src = (pg + v) * p.K + k;
    const float va = pd.topk_vals[src];
    const bool okm = va >= 0.0f;
    edge_action[dst] = okm ? pd.topk_aidx[src] : NONE;
    edge_child[dst] = NONE;
    edge_prior[dst] = okm ? va : 0.0f;
    edge_n[dst] = 0;
    edge_virt[dst] = 0;
    edge_w[dst] = 0.0f;
    if (k == 0) expanded[s_leaf[v]] = 1;
  };

  if (tid == 0) s_odd = 0;
  __syncthreads();
  // ---- phase 1: every leaf's walk to the root, all at once ----
  for (int v = tid; v < p.V; v += nt) {
    const int leaf = pd.leaves[pg + v];
    const int res = pd.results[pg + v];
    const int winner = (res == 1 || res == 3) ? 0
                       : ((res == 2 || res == 4) ? 1 : -1);
    const float term = winner < 0 ? 0.0f
                       : (pd.to_move[pg + v] == winner ? 1.0f : -1.0f);
    s_val[v] = res != ONGOING ? term : pd.values[pg + v];
    s_leaf[v] = leaf;
    s_cand[v] = res == ONGOING && leaf != 0 && expanded[leaf] == 0;
    if (t.node_virt != nullptr) atomicSub(t.node_virt + m + leaf, 1);
    int* code = path + (size_t)v * STRIDE;
    int cur = leaf, d = 0, roots = 0, odd = 0;
    while (cur != NONE && d < PATH_CAP) {
      // all of a level's loads at once, wanted or not
      const int par = parent[cur], s = parent_slot[cur];
      const int a = parent_action[cur];
      // every node above the leaf should be expanded (its row is touched)
      if (d > 0) odd |= expanded[cur] == 0;
      int c = NONE;   // a level that adds nothing
      if (par == 0 && s == NONE) {
        if (a >= 0 && a < p.A) c = -2 - a;
      } else if (par != NONE && s >= 0 && s < p.K) {
        c = par * p.K + s;
      }
      code[d] = c;
      roots += cur == 0;
      cur = par;
      ++d;
    }
    s_len[v] = d;
    s_next[v] = cur;
    s_roots[v] = roots;
    // a tail past PATH_CAP is not looked at: install in leaf order then
    if (odd || cur != NONE) s_odd = 1;
  }
  __syncthreads();
  // a leaf that occurs twice takes the first occurrence's row
  for (int v = tid; v < p.V; v += nt) {
    int first = s_cand[v];
    for (int u = 0; u < v && first; ++u)
      if (s_leaf[u] == s_leaf[v] && s_cand[u]) first = 0;
    s_first[v] = first;
  }
  __syncthreads();
  const bool in_order = s_odd != 0;
  bool installed = false;
  if (SORTED && !in_order) {
    // ---- the new leaves' rows, every thread, four slots a round trip:
    // their loads go out before any store (which the compiler may not
    // move a load over) ----
    const int total = p.V * p.K;
    for (int base = tid; base < total; base += 4 * nt) {
      float va[4];
      int ai[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * nt;
        const int v = i / p.K;
        const bool go = i < total && s_first[v];
        const size_t src = (pg + v) * p.K + (i - v * p.K);
        va[u] = go ? pd.topk_vals[src] : -1.0f;
        ai[u] = go ? pd.topk_aidx[src] : NONE;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * nt;
        const int v = i / p.K;
        if (i < total && s_first[v]) {
          const int k = i - v * p.K;
          const size_t dst = (size_t)s_leaf[v] * p.K + k;
          const bool okm = va[u] >= 0.0f;
          edge_action[dst] = okm ? ai[u] : NONE;
          edge_child[dst] = NONE;
          edge_prior[dst] = okm ? va[u] : 0.0f;
          edge_n[dst] = 0;
          edge_virt[dst] = 0;
          edge_w[dst] = 0.0f;
          if (k == 0) expanded[s_leaf[v]] = 1;
        }
      }
    }
    installed = true;
    if (sorted_apply(t, p, g, sh, STRIDE)) return;
  }

  if (warp != 0) {
    // ---- the new leaves' rows, all at once: no backup of this wave
    // touches them (every node on a path is expanded) ----
    if (in_order || installed) return;
    const int total = p.V * p.K;
#pragma unroll 4
    for (int i = tid - 32; i < total; i += nt - 32) {
      const int v = i / p.K;
      if (s_first[v]) install(v, i - v * p.K);
    }
    return;
  }

  // ---- phase 2: warp 0 applies the backups in leaf order ----
  int n0 = t.n0[g], virt0 = t.virt0[g];
  for (int v = 0; v < p.V; ++v) {
    if (in_order && s_first[v]) {
      for (int k = lane; k < p.K; k += 32) install(v, k);
      __syncwarp();
    }
    const float val = s_val[v];
    const int len = s_len[v];
    const int* code = path + (size_t)v * STRIDE;
    // the edges of one path are all different: its levels go together
    for (int d = lane; d < len; d += 32) {
      const int c = code[d];
      const float add = ((d & 1) ? 1.0f : -1.0f) * val;
      // an edge and a root action take the same instructions, so a path's
      // lanes stay together through one round trip
      const bool edge = c >= 0;
      if (edge || c <= -2)
        apply_edge(edge ? edge_n : root_n, edge ? edge_virt : root_virt,
                   edge ? edge_w : root_w, (size_t)(edge ? c : -2 - c), add);
    }
    n0 += s_roots[v];
    virt0 -= s_roots[v];
    __syncwarp();   // leaf v's levels are applied before anything later
    if (s_next[v] != NONE) {
      // ---- the rest of a path longer than PATH_CAP: one lane, serially ----
      if (lane == 0) {
        float sign = (len & 1) ? 1.0f : -1.0f;
        int cur = s_next[v];
        while (cur != NONE) {
          const int par = parent[cur], s = parent_slot[cur];
          const float add = sign * val;
          if (par == 0 && s == NONE) {
            const int a = parent_action[cur];
            if (a >= 0 && a < p.A)
              apply_edge(root_n, root_virt, root_w, (size_t)a, add);
          } else if (par != NONE && s >= 0 && s < p.K) {
            apply_edge(edge_n, edge_virt, edge_w, (size_t)par * p.K + s, add);
          }
          if (cur == 0) { n0 += 1; virt0 -= 1; }
          cur = par;
          sign = -sign;
        }
      }
      n0 = __shfl_sync(FULL, n0, 0);
      virt0 = __shfl_sync(FULL, virt0, 0);
      __syncwarp();
    }
  }
  if (lane == 0) { t.n0[g] = n0; t.virt0[g] = virt0; }
}
