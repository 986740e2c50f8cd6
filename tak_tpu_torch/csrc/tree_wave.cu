// Pool-tier tree wave kernels for the batched PUCT search (node recycling in
// a small pool), written for Hopper (sm_90a).
//
// Replaces tak_tpu/mcts/pallas_ops.py:
//   build_backup_descend_wave (:1118)  -> tak_backup_descend_wave (valid=1)
//   build_descend_wave (:1284)         -> tak_backup_descend_wave (valid=0)
//   build_expand_backup_wave (:637)    -> tak_expand_backup_wave
// The plain PyTorch version (tak_tpu_torch/mcts/tree_kernels.py) states the
// semantics; this file must agree with it bit for bit.
//
// The TPU kernels keep the whole tree of a game in VMEM.  Here the tree
// lives in global memory (the L2 holds all 32 games' trees, ~33 MB) and is
// updated in place; what a descent reads again and again is staged in
// shared memory once per launch.
//
// What bounds them on an H100: latency, not bytes or operations.  Descents
// within a game see each other's virtual marks and recycled nodes, so they
// are sequential by definition, one block per game.  Measured with clock64()
// stamps on chip_smoke's mid-search tree (32 games, V=256, K=32, A=9,036, the
// 1,280-node pool full, 58 legal root actions per game) in the first layout
// (the whole block scores all A root actions and scans the pool twice from
// global memory before warp 0 walks, lane 0 doing every read-modify-write):
// a descent 8.9 us = root pick 4.2 + victim pair 1.8 + 1.47 walk levels 1.7
// + create and eviction 0.8 + the rest 0.4; a backup 2.3 us per leaf in
// order (row install by warp 0, then lane 0's three read-modify-writes per
// level).  What this layout does about each part:
//
//   descend, the root pick.  Between two descents only the marked entry and
//     n0 + virt0 change, and few of the A actions are legal.  The legal
//     actions are staged once per launch in shared memory, in ascending
//     order (a block-wide prefix sum): for the scorers q, prior and 1 + n +
//     virt, for the walker root_child, root_n, root_virt and root_w (32 B
//     each); for the merged kernel after its backup phase, which changes
//     root_n, root_w and root_virt.  Warps 8-15 score pick v+1 while descent
//     v walks (pick v+1 needs only the mark of descent v) and keep the last
//     maximum, which in ascending order is the plain version's tie rule.
//     The walker reads the picked entry from shared memory, and the mark,
//     a root create and the eviction of a root child rewrite it beside the
//     global arrays.  Past `cap` legal actions (what the shared memory
//     holds) everyone reads the global arrays instead.
//   descend, the victim pair.  The reference computes the pair once per
//     descent because nothing that affects candidacy changes between a
//     descent's start and its create (pallas_ops.py:166-172).  node_n,
//     node_virt, child_count, the parent links and the staged entry of a
//     root child's action are mirrored in shared memory (28 B a node); the
//     walker updates the mirrors beside every global write that changes
//     them (the pin, the create's parent, the evicted victim and its old
//     parent), so warps 1-7 find pair v in one two-smallest reduction over
//     the mirrors while walk v runs, from the state that descent v-1 left,
//     and hand over the two victims ready to use.  The walker waits for
//     them at a create that finds the pool full (every create, once the
//     pool has filled up) and at the end of the descent.
//   descend, a level.  Warp 0 walks: at K=32 one slot per lane, the six
//     loads out first, c_puct and sqrtf under them, the last maximum by two
//     redux.sync over an order-preserving key, then the chosen slot's fields
//     by shuffle from the lane that scored it.  Other K load up to four slots
//     a lane per round trip.
//   expand+backup (#3, and the first half of #2).  `backup_wave` of
//     tree_common.cuh, as the large-tree tier runs it, with the unpins of
//     recycling; the path buffer holds 32 levels a leaf (the pool tier's
//     trees are shallow), a longer path is finished serially.
//
// Named barriers hand over between the roles, each used in one direction
// and strictly alternating: pick ready / mark done (walker and warps 8-15),
// pair ready (walker and warp 1) / descent done (walker and warps 1-7); a
// fifth gathers warps 1-7's partial pairs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast-math: logf/sqrtf/division must round as PyTorch's own CUDA ops do).

#include "tree_common.cuh"

#define INT_INF (1 << 30)
#define THREADS 512
#define PAIR_WARPS 7               // warps 1-7: the victim pair
#define PAIR_THREADS (PAIR_WARPS * 32)
#define PICK_WARPS 8               // warps 8-15: the root pick
#define PICK_THREADS (PICK_WARPS * 32)
#define PICK_FIRST (32 + PAIR_THREADS)
#define BACKUP_THREADS 512         // the flush kernel
#define POOL_PATH_CAP 32           // levels of a path kept in shared memory
#define NODE_MIRRORS 7             // ints a node in shared memory (recycling)
#define STAGE_WORDS 8              // words a staged root action
#define SMEM_MAX 232448            // shared memory a block may use
#define SMEM_STATIC 1024           // above what the kernel declares statically
#define BAR_PICK 1                 // named barriers (0 is __syncthreads)
#define BAR_MARK 2
#define BAR_PAIR 3
#define BAR_DONE 4
#define BAR_PAIRS 5                // the pair warps among themselves
#define BAR_PICKS 6                // the pick warps among themselves

struct Tree {
  int* parent; int* parent_slot; int* parent_action; unsigned char* expanded;
  int* node_n; int* node_virt; int* child_count;
  int* edge_action; float* edge_prior; int* edge_child; int* edge_n;
  int* edge_virt; float* edge_w;
  float* root_prior; int* root_child; const unsigned char* root_legal;
  int* root_n; int* root_virt; float* root_w;
  int* n0; int* virt0; int* next_free;
};

__device__ __forceinline__ BackupTree backup_view(const Tree& t, int recycle) {
  BackupTree b;
  b.parent = t.parent; b.parent_slot = t.parent_slot;
  b.parent_action = t.parent_action; b.expanded = t.expanded;
  b.edge_action = t.edge_action; b.edge_prior = t.edge_prior;
  b.edge_child = t.edge_child; b.edge_n = t.edge_n; b.edge_virt = t.edge_virt;
  b.edge_w = t.edge_w; b.root_n = t.root_n; b.root_virt = t.root_virt;
  b.root_w = t.root_w; b.n0 = t.n0; b.virt0 = t.virt0;
  b.node_virt = recycle ? t.node_virt : nullptr;
  return b;
}

// Keep the two smallest of (a1 <= a2) and (b1 <= b2); keys are distinct
// (the node index is in the low digits) or INT_INF.
__device__ __forceinline__ void two_min_merge(int& a1, int& a2, int b1,
                                              int b2) {
  const int hi = min(max(a1, b1), min(a2, b2));
  a1 = min(a1, b1);
  a2 = hi;
}

// V sequential virtual-loss PUCT descents of game g, the whole block.
// `sh` holds the node mirrors (recycling) and the staged root actions.
__device__ void descend_wave(const Tree& t, const Dims p, int recycle,
                             int cap, int g, int* sh, int* leaves_out,
                             unsigned char* created_out) {
  __shared__ float pk_s[PICK_WARPS];
  __shared__ int pk_i[PICK_WARPS];
  __shared__ int s_pair[PAIR_WARPS][2];
  __shared__ int s_vic[4];                 // v1, v2, have1, have2
  __shared__ int s_pick[2];                // staged index (or -1), action
  __shared__ int s_warp[THREADS / 32];
  __shared__ int s_legal;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t m = (size_t)g * p.M, mk = m * p.K, ao = (size_t)g * p.A;
  int* parent = t.parent + m;
  int* parent_slot = t.parent_slot + m;
  int* parent_action = t.parent_action + m;
  unsigned char* expanded = t.expanded + m;
  int* node_n = t.node_n + m;
  int* node_virt = t.node_virt + m;
  int* child_count = t.child_count + m;
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
  // node mirrors (recycling only): node_n, node_virt, child_count, the
  // parent links, and the staged index of a root child's action (or -1)
  const int nodes = recycle ? p.M : 0;
  int* m_n = sh;
  int* m_virt = m_n + nodes;
  int* m_cc = m_virt + nodes;
  int* m_par = m_cc + nodes;
  int* m_slot = m_par + nodes;
  int* m_act = m_slot + nodes;
  int* m_rj = m_act + nodes;
  // the staged root actions: the scorers' id, q, prior, 1 + n + virt, and
  // root_child, root_n, root_virt, root_w as the walker changes them
  int* s_act = sh + (size_t)NODE_MIRRORS * nodes;
  float* s_q = (float*)(s_act + cap);
  float* s_prior = s_q + cap;
  float* s_den = s_prior + cap;
  int* s_child = (int*)(s_den + cap);
  int* s_n = s_child + cap;
  int* s_virt = s_n + cap;
  float* s_w = (float*)(s_virt + cap);

  const int n0 = t.n0[g];
  const int virt0 = t.virt0[g];
  const int PK = ((p.M + 127) / 128) * 128;

  // ---- the node mirrors ----
  for (int i = tid; i < nodes; i += THREADS) {
    m_n[i] = node_n[i];
    m_virt[i] = node_virt[i];
    m_cc[i] = child_count[i];
    m_par[i] = parent[i];
    m_slot[i] = parent_slot[i];
    m_act[i] = parent_action[i];
    m_rj[i] = -1;
  }
  // ---- the legal root actions, ascending: each thread counts the legal
  // actions of its stretch, a block-wide prefix sum places them ----
  const int per = (p.A + THREADS - 1) / THREADS;
  const int lo = min(tid * per, p.A), hi = min(lo + per, p.A);
  int cnt = 0;
  for (int a = lo; a < hi; ++a) cnt += root_legal[a] != 0;
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < THREADS / 32 ? s_warp[lane] : 0;
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, wi, off);
      if (lane >= off) wi += x;
    }
    if (lane < THREADS / 32) s_warp[lane] = wi - w;
    if (lane == 31) s_legal = wi;
  }
  __syncthreads();
  const int legal = s_legal;
  const bool staged = legal <= cap;   // the same for the whole block
  if (staged) {
    int j = s_warp[warp] + incl - cnt;
    for (int a = lo; a < hi; ++a)
      if (root_legal[a]) s_act[j++] = a;
    __syncthreads();
    for (j = tid; j < legal; j += THREADS) {
      const int a = s_act[j];
      const int rn = root_n[a], rv = root_virt[a];
      const float rw = root_w[a];
      s_q[j] = q_term(rn, rv, rw);
      s_prior[j] = root_prior[a];
      s_den[j] = 1.0f + (float)(rn + rv);
      s_child[j] = root_child[a];
      s_n[j] = rn;
      s_virt[j] = rv;
      s_w[j] = rw;
    }
    // a root child's staged entry, for its eviction: binary search
    for (int i = tid; i < nodes; i += THREADS) {
      if (m_par[i] != 0 || m_slot[i] != NONE) continue;
      const int a = m_act[i];
      int lo_j = 0, hi_j = legal;
      while (lo_j < hi_j) {
        const int mid = (lo_j + hi_j) >> 1;
        if (s_act[mid] < a) lo_j = mid + 1; else hi_j = mid;
      }
      if (lo_j < legal && s_act[lo_j] == a) m_rj[i] = lo_j;
    }
  }
  __syncthreads();

  if (warp >= 1 + PAIR_WARPS) {
    // ---- the root pick of descent v, one descent ahead.  Staged: the index
    // into the legal list; else the action, from global memory ----
    const int st = tid - PICK_FIRST, sw = warp - 1 - PAIR_WARPS;
    int marked = -1;   // the staged entry of the last pick
    for (int v = 0; v < p.V; ++v) {
      if (v > 0) {
        bar_sync(BAR_MARK, PICK_THREADS + 32);   // mark v-1 applied
        marked = s_pick[0];
      }
      const float n0f = (float)(n0 + virt0 + v);
      const float cp = c_puct(n0f, p.base, p.init);
      const float sq = sqrtf(n0f);
      float best_s = -INFINITY;
      int best_i = -1;
      if (staged) {
        for (int j = st; j < legal; j += PICK_THREADS) {
          float q = s_q[j], den = s_den[j];
          if (j == marked) {
            // the one thread that scores entry j brings it up to date
            q = q_term(s_n[j], s_virt[j], s_w[j]);
            den = 1.0f + (float)(s_n[j] + s_virt[j]);
            s_q[j] = q;
            s_den[j] = den;
          }
          const float u = cp * s_prior[j] * sq / den;
          const float sc = (q + u) + 0.0f;
          if (sc >= best_s) { best_s = sc; best_i = j; }
        }
      } else {
#pragma unroll 2
        for (int a = st; a < p.A; a += PICK_THREADS) {
          const int rv = root_virt[a], rn = root_n[a];
          const float q = q_term(rn, rv, root_w[a]);
          const float u = cp * root_prior[a] * sq / (1.0f + (float)(rn + rv));
          const float sc = root_legal[a] ? (q + u) + 0.0f : -INFINITY;
          if (sc >= best_s) { best_s = sc; best_i = a; }
        }
      }
      warp_argmax_last(best_s, best_i);
      if (lane == 0) { pk_s[sw] = best_s; pk_i[sw] = best_i; }
      bar_sync(BAR_PICKS, PICK_THREADS);
      if (sw == 0) {
        // warp 8 merges the eight warps' picks and hands the action over
        best_s = lane < PICK_WARPS ? pk_s[lane] : -INFINITY;
        best_i = lane < PICK_WARPS ? pk_i[lane] : -1;
        for (int off = 4; off > 0; off >>= 1) {
          const float s2 = __shfl_xor_sync(FULL, best_s, off);
          const int i2 = __shfl_xor_sync(FULL, best_i, off);
          argmax_last_merge(best_s, best_i, s2, i2);
        }
        if (lane == 0) {
          // with no legal action every score is -inf and the last action
          // wins
          s_pick[0] = staged ? best_i : -1;
          s_pick[1] = best_i < 0 ? p.A - 1
                                 : (staged ? s_act[best_i] : best_i);
        }
        __threadfence_block();
        __syncwarp();
        bar_arrive(BAR_PICK, 64);
      }
    }
    return;
  }

  if (warp >= 1) {
    // ---- the victim pair of descent v: the two smallest keys
    // min(node_n, clamp) * PK + i over the candidates (childless, unpinned,
    // not the root), from the state descent v-1 left ----
    if (!recycle) return;
    const int pt = tid - 32, pw = warp - 1;
    const int clamp_n = INT_INF / PK - 1;
    for (int v = 0; v < p.V; ++v) {
      if (v > 0) bar_sync(BAR_DONE, PAIR_THREADS + 32);   // descent v-1 done
      int a1 = INT_INF, a2 = INT_INF;
      for (int i = pt; i < p.M; i += PAIR_THREADS) {
        const bool cand = i > 0 && m_cc[i] == 0 && m_virt[i] == 0;
        const int key = cand ? min(m_n[i], clamp_n) * PK + i : INT_INF;
        two_min_merge(a1, a2, key, INT_INF);
      }
      for (int off = 16; off > 0; off >>= 1)
        two_min_merge(a1, a2, __shfl_xor_sync(FULL, a1, off),
                      __shfl_xor_sync(FULL, a2, off));
      if (lane == 0) { s_pair[pw][0] = a1; s_pair[pw][1] = a2; }
      bar_sync(BAR_PAIRS, PAIR_THREADS);
      if (pw == 0) {
        // warp 1 merges the seven warps' pairs and hands the victims over
        a1 = lane < PAIR_WARPS ? s_pair[lane][0] : INT_INF;
        a2 = lane < PAIR_WARPS ? s_pair[lane][1] : INT_INF;
        for (int off = 4; off > 0; off >>= 1)
          two_min_merge(a1, a2, __shfl_xor_sync(FULL, a1, off),
                        __shfl_xor_sync(FULL, a2, off));
        if (lane == 0) {
          s_vic[0] = a1 % PK;
          s_vic[1] = a2 % PK;
          s_vic[2] = a1 < INT_INF;
          s_vic[3] = a2 < INT_INF;
        }
        __threadfence_block();
        __syncwarp();
        bar_arrive(BAR_PAIR, 64);
      }
    }
    return;
  }

  // ---- warp 0 walks; every lane carries the same scalar state ----
  int nf = t.next_free[g];
  bool paired = false;
  auto get_pair = [&]() {
    if (paired) return;
    bar_sync(BAR_PAIR, 64);
    paired = true;
  };
  // Slot allocation: a fresh slot while the pool has room, else evict the
  // coldest candidate (the second when the first is `cur`); eviction
  // detaches the victim from its parent edge or the root tier.
  auto alloc = [&](bool want, int cur, int& slot, bool& ok) {
    const bool fresh = nf < p.M;
    slot = nf;
    ok = want && fresh;
    if (want && !fresh && recycle) {
      get_pair();
      const bool use2 = s_vic[0] == cur;
      const int victim = s_vic[use2 ? 1 : 0];
      const bool have = s_vic[use2 ? 3 : 2] != 0;
      if (have) {
        if (lane == 0) {
          const int pv = m_par[victim], sv = m_slot[victim];
          if (pv == 0 && sv == NONE) {
            const int av = m_act[victim];
            if (av >= 0 && av < p.A) {
              root_child[av] = NONE;
              if (m_rj[victim] >= 0) s_child[m_rj[victim]] = NONE;
            }
          } else if (pv >= 0 && sv >= 0 && sv < p.K) {
            edge_child[(size_t)pv * p.K + sv] = NONE;
          }
          if (pv >= 0) child_count[pv] = --m_cc[pv];
          expanded[victim] = 0;
          node_n[victim] = m_n[victim] = 0;
        }
        __syncwarp();
      }
      slot = victim;
      ok = have;
    }
    if (want && fresh) nf += 1;
  };
  // The links of a created node, in global memory and in the mirrors
  // (`rj`: the staged entry of a root child's action, else -1).
  auto link = [&](int slot, int par, int pslot, int action, int n, int rj) {
    parent[slot] = par;
    parent_slot[slot] = pslot;
    expanded[slot] = 0;
    parent_action[slot] = action;
    if (recycle) {
      child_count[par] = ++m_cc[par];
      node_n[slot] = m_n[slot] = n;
      m_par[slot] = par;
      m_slot[slot] = pslot;
      m_act[slot] = action;
      m_rj[slot] = rj;
    }
  };

  for (int v = 0; v < p.V; ++v) {
    bar_sync(BAR_PICK, 64);
    const int pick = s_pick[0], a0 = s_pick[1];
    const bool in_stage = pick >= 0;
    int c0, rn, rv;
    if (in_stage) {
      c0 = s_child[pick]; rn = s_n[pick]; rv = s_virt[pick];
    } else {
      c0 = root_child[a0]; rn = root_n[a0]; rv = root_virt[a0];
    }
    int slot0;
    bool ok0;
    alloc(c0 == NONE, 0, slot0, ok0);
    if (lane == 0) {
      if (c0 != NONE || ok0) {
        root_virt[a0] = rv + 1;
        if (in_stage) s_virt[pick] = rv + 1;   // its scorer updates q
      }
      if (ok0) {
        root_child[a0] = slot0;
        if (in_stage) s_child[pick] = slot0;
        link(slot0, 0, NONE, a0, rn, in_stage ? pick : -1);
      }
    }
    __threadfence_block();
    __syncwarp();
    if (v + 1 < p.V) bar_arrive(BAR_MARK, PICK_THREADS + 32);
    int leaf = ok0 ? slot0 : 0;
    bool created = ok0;
    int cur = ok0 ? NONE : c0;
    int nv = rn + rv;

    // ---- walk down the tree until a leaf resolves ----
    while (cur != NONE) {
      const size_t row = (size_t)cur * p.K;
      const bool exp = expanded[cur] != 0;
      const float npf = (float)nv;
      Best b = {-INFINITY, -1, NONE, NONE, 0, 0};
      if (p.K == 32) {
        // one slot per lane: the six loads go out before c_puct and sqrtf
        const size_t e = row + lane;
        const int ea = edge_action[e], ec = edge_child[e];
        const int en = edge_n[e], ev = edge_virt[e];
        const float ep = edge_prior[e], ew = edge_w[e];
        score_slot(b, lane, ea, ec, en, ev, ep, ew,
                   c_puct(npf, p.base, p.init), sqrtf(npf));
      } else {
        const float cpe = c_puct(npf, p.base, p.init);
        const float sqe = sqrtf(npf);
        // up to four slots a lane per round trip: their loads go out first
        for (int base = 0; base < p.K; base += 128) {
          int ea[4], ec[4], en[4], ev[4];
          float ep[4], ew[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = base + 32 * j + lane;
            const bool in = k < p.K;
            const size_t e = row + (in ? k : 0);
            ea[j] = in ? edge_action[e] : NONE;
            ec[j] = in ? edge_child[e] : NONE;
            en[j] = in ? edge_n[e] : 0;
            ev[j] = in ? edge_virt[e] : 0;
            ep[j] = in ? edge_prior[e] : 0.0f;
            ew[j] = in ? edge_w[e] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = base + 32 * j + lane;
            if (k < p.K)
              score_slot(b, k, ea[j], ec[j], en[j], ev[j], ep[j], ew[j],
                         cpe, sqe);
          }
        }
      }
      // the last maximum over the row; the lane that scored it has its fields
      const unsigned key = score_key(b.s);
      const unsigned top = __reduce_max_sync(FULL, key);
      const int slot = __reduce_max_sync(FULL, key == top ? b.slot : -1);
      const int owner = slot & 31;
      const int child = __shfl_sync(FULL, b.child, owner);
      const int action = __shfl_sync(FULL, b.action, owner);
      const int en_s = __shfl_sync(FULL, b.n, owner);
      const int ev_s = __shfl_sync(FULL, b.virt, owner);
      const bool want = exp && child == NONE;
      int slot_c;
      bool ok_c;
      alloc(want, cur, slot_c, ok_c);
      if (lane == 0) {
        const size_t e = row + slot;
        if (exp) edge_virt[e] = ev_s + 1;
        if (ok_c) {
          edge_child[e] = slot_c;
          link(slot_c, cur, slot, action, en_s, -1);
        }
      }
      __syncwarp();
      const bool stopping = !exp || want;
      if (stopping) leaf = ok_c ? slot_c : cur;
      if (ok_c) created = true;
      if (!stopping) nv = en_s + ev_s;
      cur = stopping ? NONE : child;
    }
    if (recycle) {
      get_pair();   // pair v is read before the pin changes the mirrors
      if (lane == 0) node_virt[leaf] = ++m_virt[leaf];
      paired = false;
    }
    if (lane == 0) {
      leaves_out[(size_t)g * p.V + v] = leaf;
      created_out[(size_t)g * p.V + v] = created ? 1 : 0;
    }
    __threadfence_block();
    __syncwarp();
    if (recycle && v + 1 < p.V) bar_arrive(BAR_DONE, PAIR_THREADS + 32);
  }
  if (lane == 0) {
    t.virt0[g] = virt0 + p.V;
    t.next_free[g] = nf;
  }
}

__global__ void __launch_bounds__(THREADS)
backup_descend_kernel(Tree t, PendingWave pd, Dims p, int recycle, int cap,
                      int valid, int* leaves_out, unsigned char* created_out) {
  extern __shared__ int sh[];
  if (valid) {
    backup_wave<POOL_PATH_CAP, true>(backup_view(t, recycle), pd, p,
                                     blockIdx.x, sh);
    __syncthreads();   // the backups' writes are seen by the staging
  }
  descend_wave(t, p, recycle, cap, blockIdx.x, sh, leaves_out, created_out);
}

__global__ void __launch_bounds__(BACKUP_THREADS)
expand_backup_kernel(Tree t, PendingWave pd, Dims p, int recycle) {
  extern __shared__ int sh[];
  backup_wave<POOL_PATH_CAP, true>(backup_view(t, recycle), pd, p,
                                   blockIdx.x, sh);
}

static void fill(Tree& t, PendingWave& pd, void** a) {
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

// Raise a kernel's dynamic shared memory limit once it needs more.
template <typename Kernel>
static int reserve(Kernel kernel, size_t bytes, size_t& sized) {
  if (bytes <= sized) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  sized = bytes;
  return 0;
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

// The wrapper keeps V, K and (with recycling) M within what the shared
// memory holds: the node mirrors and the backup's paths always fit, the
// staged root actions take the rest up to A.
extern "C" int tak_backup_descend_wave(int B, int M, int K, int A, int V,
                                       int recycle, float base, float init,
                                       int valid, TREE_ARGS, void* leaves,
                                       void* created, void* stream) {
  Tree t;
  PendingWave pd;
  void* a[28] = TREE_ARRAY;
  fill(t, pd, a);
  const Dims p = {B, M, K, A, V, base, init};
  const size_t node_bytes =
      recycle ? sizeof(int) * NODE_MIRRORS * (size_t)M : 0;
  const size_t room = SMEM_MAX - SMEM_STATIC - node_bytes;
  const size_t fit = room / (STAGE_WORDS * sizeof(int));
  const int cap = (int)(fit < (size_t)A ? fit : (size_t)A);
  size_t bytes = node_bytes + STAGE_WORDS * sizeof(int) * (size_t)cap;
  const size_t backup = backup_smem_bytes<POOL_PATH_CAP, true>(V);
  if (valid && backup > bytes) bytes = backup;
  static size_t sized = 48 * 1024;
  const int err = reserve(backup_descend_kernel, bytes, sized);
  if (err) return err;
  backup_descend_kernel<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      t, pd, p, recycle, cap, valid, (int*)leaves, (unsigned char*)created);
  return (int)cudaGetLastError();
}

extern "C" int tak_expand_backup_wave(int B, int M, int K, int A, int V,
                                      int recycle, float base, float init,
                                      int valid, TREE_ARGS, void* leaves,
                                      void* created, void* stream) {
  (void)base; (void)init; (void)valid; (void)leaves; (void)created;
  Tree t;
  PendingWave pd;
  void* a[28] = TREE_ARRAY;
  fill(t, pd, a);
  const Dims p = {B, M, K, A, V, 0.0f, 0.0f};
  const size_t bytes = backup_smem_bytes<POOL_PATH_CAP, true>(V);
  static size_t sized = 48 * 1024;
  const int err = reserve(expand_backup_kernel, bytes, sized);
  if (err) return err;
  expand_backup_kernel<<<B, BACKUP_THREADS, bytes, (cudaStream_t)stream>>>(
      t, pd, p, recycle);
  return (int)cudaGetLastError();
}
