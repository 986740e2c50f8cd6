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
// caches what a walk touches, so none of that exists.  The recycling fields
// (node_n, node_virt, child_count) are not arguments of these kernels.
//
// What bounds them on an H100: latency, not bytes or operations.  Descents
// within a game see each other's virtual marks, so they are sequential by
// definition, and each is a chain of dependent steps: per tree level one
// round trip to the L2 for the node's edge rows, then the scores, then the
// choice, and nothing of the next level can start before.  The launch
// occupies one SM per game.  Measured with clock64() stamps on the Player's
// tree (one game, V=64, K=128, A=9,036, 51,201 nodes, mean depth 27) in the
// first layout (1,024 threads score all A root actions from global memory,
// then warp 0 walks alone, 4 slots per lane): 4.05 ms = 64 root passes of
// 3.45 us + 1,721 levels of 2.21 us.  A level was four round trips (the
// slot loop stayed rolled, so each slot waited for its own loads), some 350
// dependent instructions of one warp (c_puct's logf and division, sqrtf,
// eight IEEE divisions per lane), ten shuffles and lane 0's
// read-modify-write.  The backup kernel's thread 0 walked 64 x 27 levels of
// two dependent loads and three read-modify-writes, 0.46 ms.  In this layout
// (same tree, same card): descend 1.08 ms, a level 0.62 us (loads and score
// 0.37, the four warps' agreement 0.22, the mark 0.06), expand+backup 0.056
// ms.  What it does about each part:
//
//   descend, the root pick.  Between two descents only the marked entry and
//     the scalar n0 + virt0 change, and few of the A actions are legal (104
//     of 9,036 on that tree).  The legal actions are staged once per launch
//     in shared memory, in ascending order (a block-wide prefix sum), as q,
//     prior and the denominator 1 + n + virt; a pick scores those with the
//     plain version's expression for u and keeps the last maximum, which in
//     ascending order is the plain version's tie rule.  The mark rewrites
//     the entry's q and denominator beside the global root_virt.  If more
//     actions are legal than the shared memory holds (`cap`, from the
//     host), the scorers read the five global arrays instead.
//   descend, overlap.  Warps 0-3 walk; warps 4-15 score.  Pick v+1 needs
//     only the root tier after mark v, which warp 0 applies before walk v
//     starts, so the scorers compute pick v+1 during walk v (one descent
//     ahead: mark v+1 needs next_free after walk v).  Two named barriers
//     hand over (pick ready, mark done); the scorers sleep in bar.sync while
//     the walk runs.
//   descend, a level.  Four warps walk together, one slot per lane at
//     K=128: six coalesced loads per lane go out first, c_puct and sqrtf run
//     under them, and a lane scores one slot instead of four (an unvisited
//     slot, most of a row, needs no division at all).  Each warp finds its
//     last maximum with two redux.sync over an order-preserving key, the
//     four candidates meet in shared memory behind a third named barrier,
//     every warp picks the same winner and carries the same cur, nv and
//     next_free, and the one thread that scored the chosen slot writes the
//     mark from the value it loaded and links a created node.  Other K take
//     the same code with a strided loop.
//   expand+backup.  `backup_wave` of tree_common.cuh (the pool tier runs it
//     too): every leaf's path recorded in parallel, the new rows installed
//     by the idle warps, then warp 0 applies the leaves in order, a path's
//     levels together, each with its three loads before its three stores.
//     The recorded paths take 544 B a leaf; a wave too wide for the shared
//     memory (above some 427 leaves) keeps them in a global buffer that the
//     wrapper allocates, so any wave the reference takes runs in one launch
//     (splitting the wave would change which occurrence of a repeated leaf
//     installs its row).
//   Tried and dropped: prefetch.global.L1 of the chosen child's rows (and of
//     the next leaf's lines in the backup) made both kernels slower; a table
//     of c_puct and sqrtf by visit total in shared memory changed nothing
//     (the row loads, not those terms, are what a level waits for).
//
// tak_parent_chase and tak_child_chase are measuring aids, not ported
// kernels: one thread follows a wave's paths, up through `parent` or down
// through `edge_child`, one dependent load per level: the round trips that
// no layout of the two kernels can avoid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast-math: logf/sqrtf/division must round as PyTorch's own CUDA ops do).
// Index arithmetic is size_t: B*M*K reaches 2^24 per game.

#include "tree_common.cuh"

#define DESCEND_THREADS 512        // four warps walk, the others score
#define WALK_WARPS 4
#define WALK_THREADS (WALK_WARPS * 32)
#define SCORE_WARPS (DESCEND_THREADS / 32 - WALK_WARPS)
#define SCORE_THREADS (SCORE_WARPS * 32)
#define PICK_THREADS (SCORE_THREADS + 32)   // the scorers and warp 0
#define ROOT_STAGE_MAX 14000       // legal root actions staged, 16 B each
#define BACKUP_THREADS 256
#define PATH_CAP 128               // levels of a path kept in shared memory
#define BAR_PICK 1                 // named barriers (0 is __syncthreads)
#define BAR_MARK 2
#define BAR_WALK 3

struct DescendTree {
  int* parent; int* parent_slot; int* parent_action;
  const unsigned char* expanded;
  const int* edge_action; const float* edge_prior; int* edge_child;
  const int* edge_n; int* edge_virt; const float* edge_w;
  const float* root_prior; int* root_child; const unsigned char* root_legal;
  const int* root_n; int* root_virt; const float* root_w;
  const int* n0; int* virt0; int* next_free;
};

// `cap` is the number of legal root actions the dynamic shared memory can
// stage.
__global__ void __launch_bounds__(DESCEND_THREADS)
descend_hbm_kernel(DescendTree t, Dims p, int cap, int* leaves_out,
                   unsigned char* created_out) {
  // the legal root actions, ascending: id, q, prior, 1 + n + virt
  extern __shared__ float stage[];
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int s_warp[DESCEND_THREADS / 32];
  __shared__ int s_legal;
  __shared__ int s_root[2][2];            // per descent: root child, visits
  __shared__ int4 s_cand[2][WALK_WARPS];  // per level: key, slot, child, visits
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
  int* s_act = (int*)stage;
  float* s_q = stage + cap;
  float* s_prior = stage + 2 * (size_t)cap;
  float* s_den = stage + 3 * (size_t)cap;

  const int n0 = t.n0[g];
  const int virt0 = t.virt0[g];

  // ---- stage the legal root actions once per launch: each thread counts
  // the legal actions of its stretch, a block-wide prefix sum places them
  // in ascending order ----
  const int per = (p.A + DESCEND_THREADS - 1) / DESCEND_THREADS;
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
    const int w = lane < DESCEND_THREADS / 32 ? s_warp[lane] : 0;
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, wi, off);
      if (lane >= off) wi += x;
    }
    if (lane < DESCEND_THREADS / 32) s_warp[lane] = wi - w;
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
    // legal actions lie in runs, so the entries are filled one per thread
    for (j = tid; j < legal; j += DESCEND_THREADS) {
      const int a = s_act[j];
      const int rn = root_n[a], rv = root_virt[a];
      s_q[j] = q_term(rn, rv, root_w[a]);
      s_prior[j] = root_prior[a];
      s_den[j] = 1.0f + (float)(rn + rv);
    }
  }
  __syncthreads();

  if (warp >= WALK_WARPS) {
    // ---- scorers: the PUCT pick of descent v, one descent ahead.  Staged:
    // the index into the legal list; else the action, from global memory ----
    const int st = tid - WALK_THREADS, sw = warp - WALK_WARPS;
    for (int v = 0; v < p.V; ++v) {
      if (v > 0) bar_sync(BAR_MARK, PICK_THREADS);   // mark v-1 applied
      const float n0f = (float)(n0 + virt0 + v);
      const float cp = c_puct(n0f, p.base, p.init);
      const float sq = sqrtf(n0f);
      float best_s = -INFINITY;
      int best_i = -1;
      if (staged) {
        for (int j = st; j < legal; j += SCORE_THREADS) {
          const float u = cp * s_prior[j] * sq / s_den[j];
          const float sc = (s_q[j] + u) + 0.0f;
          if (sc >= best_s) { best_s = sc; best_i = j; }
        }
      } else {
#pragma unroll 2
        for (int a = st; a < p.A; a += SCORE_THREADS) {
          const int rv = root_virt[a], rn = root_n[a];
          const float q = q_term(rn, rv, root_w[a]);
          const float u = cp * root_prior[a] * sq / (1.0f + (float)(rn + rv));
          const float sc = root_legal[a] ? (q + u) + 0.0f : -INFINITY;
          if (sc >= best_s) { best_s = sc; best_i = a; }
        }
      }
      warp_argmax_last(best_s, best_i);
      if (lane == 0) { red_s[sw] = best_s; red_i[sw] = best_i; }
      __threadfence_block();
      __syncwarp();
      bar_arrive(BAR_PICK, PICK_THREADS);
    }
    return;
  }

  // ---- the walkers: warp 0 marks the pick; then the four warps walk down
  // together, a slot per lane, and agree on every level's choice through
  // s_cand, so each carries the same cur, nv and nf ----
  int nf = t.next_free[g];
  int buf = 0;
  for (int v = 0; v < p.V; ++v) {
    if (warp == 0) {
      bar_sync(BAR_PICK, PICK_THREADS);
      float ps = lane < SCORE_WARPS ? red_s[lane] : -INFINITY;
      int pick = lane < SCORE_WARPS ? red_i[lane] : -1;
      warp_argmax_last(ps, pick);
      // with no legal action every score is -inf and the last action wins
      const int a0 = pick < 0 ? p.A - 1 : (staged ? s_act[pick] : pick);
      if (lane == 0) {
        const int c0 = root_child[a0];
        const int rn = root_n[a0], rv = root_virt[a0];
        const bool room0 = nf < p.M;
        // no mark on a rootward create that finds the pool full
        if (c0 != NONE || room0) {
          root_virt[a0] = rv + 1;
          if (staged && pick >= 0) {
            s_q[pick] = q_term(rn, rv + 1, root_w[a0]);
            s_den[pick] = 1.0f + (float)(rn + rv + 1);
          }
        }
        if (c0 == NONE && room0) {
          root_child[a0] = nf;
          parent[nf] = 0;
          parent_slot[nf] = NONE;
          parent_action[nf] = a0;
        }
        s_root[v & 1][0] = c0;
        s_root[v & 1][1] = rn + rv;
      }
      __threadfence_block();
      __syncwarp();
      if (v + 1 < p.V) bar_arrive(BAR_MARK, PICK_THREADS);
    }
    bar_sync(BAR_WALK, WALK_THREADS);
    const int c0 = s_root[v & 1][0];
    int nv = s_root[v & 1][1];
    const bool create0 = c0 == NONE && nf < p.M;
    int leaf_v = create0 ? nf : 0;
    bool created_v = create0;
    int cur = create0 ? NONE : c0;
    if (create0) nf += 1;

    // ---- walk down the tree until a leaf resolves ----
    while (cur != NONE) {
      const size_t row = (size_t)cur * p.K;
      const bool exp = expanded[cur] != 0;
      Best b = {-INFINITY, -1, NONE, NONE, 0, 0};
      if (p.K == WALK_THREADS) {
        // one slot per lane: the six loads go out before c_puct and sqrtf
        const size_t e = row + tid;
        const int ea = edge_action[e], ec = edge_child[e];
        const int en = edge_n[e], ev = edge_virt[e];
        const float ep = edge_prior[e], ew = edge_w[e];
        const float npf = (float)nv;
        score_slot(b, tid, ea, ec, en, ev, ep, ew,
                   c_puct(npf, p.base, p.init), sqrtf(npf));
      } else {
        const float npf = (float)nv;
        const float cpe = c_puct(npf, p.base, p.init);
        const float sqe = sqrtf(npf);
        for (int k = tid; k < p.K; k += WALK_THREADS)
          score_slot(b, k, edge_action[row + k], edge_child[row + k],
                     edge_n[row + k], edge_virt[row + k], edge_prior[row + k],
                     edge_w[row + k], cpe, sqe);
      }
      // the last maximum of this warp's slots, then of the four warps'
      const unsigned key = score_key(b.s);
      const unsigned top = __reduce_max_sync(FULL, key);
      const int slot_w = __reduce_max_sync(FULL, key == top ? b.slot : -1);
      if (b.slot == slot_w && (slot_w >= 0 || lane == 0))
        s_cand[buf][warp] = make_int4((int)top, slot_w, b.child, b.n + b.virt);
      bar_sync(BAR_WALK, WALK_THREADS);
      int4 win = s_cand[buf][0];
#pragma unroll
      for (int w = 1; w < WALK_WARPS; ++w) {
        const int4 c = s_cand[buf][w];
        if ((unsigned)c.x > (unsigned)win.x ||
            ((unsigned)c.x == (unsigned)win.x && c.y > win.y))
          win = c;
      }
      buf ^= 1;
      const int slot = win.y, child = win.z, cnv = win.w;
      const bool want = exp && child == NONE;
      const bool ok = want && nf < p.M;
      if (slot >= 0 && b.slot == slot) {   // the thread that scored the slot
        const size_t e = row + slot;
        if (exp) edge_virt[e] = b.virt + 1;
        if (ok) {
          edge_child[e] = nf;
          parent[nf] = cur;
          parent_slot[nf] = slot;
          parent_action[nf] = b.action;
        }
      }
      const bool stopping = !exp || want;
      if (stopping) leaf_v = ok ? nf : cur;
      if (ok) { created_v = true; nf += 1; }
      if (!stopping) nv = cnv;
      cur = stopping ? NONE : child;
    }
    if (tid == 0) {
      leaves_out[(size_t)g * p.V + v] = leaf_v;
      created_out[(size_t)g * p.V + v] = created_v ? 1 : 0;
    }
  }
  if (tid == 0) {
    t.virt0[g] = virt0 + p.V;
    t.next_free[g] = nf;
  }
}

// The recorded paths live in shared memory, or, where a wave's do not fit
// (`scratch` not null: V above some 427 leaves), in the game's own stretch
// of a global buffer, read and written exactly as the shared array.
__global__ void __launch_bounds__(BACKUP_THREADS)
expand_backup_hbm_kernel(BackupTree t, PendingWave pd, Dims p,
                         int* scratch) {
  extern __shared__ int sh[];
  const size_t words = backup_smem_bytes<PATH_CAP>(p.V) / sizeof(int);
  int* paths = scratch == nullptr ? sh : scratch + blockIdx.x * words;
  backup_wave<PATH_CAP>(t, pd, p, blockIdx.x, paths);
}

// One thread per game follows the parent links of the wave's leaves, leaf
// after leaf: one dependent load per level.
__global__ void parent_chase_kernel(const int* parent, const int* leaves,
                                    int M, int V, int* levels_out) {
  const int g = blockIdx.x;
  const int* par = parent + (size_t)g * M;
  int levels = 0;
  for (int v = 0; v < V; ++v) {
    int cur = leaves[(size_t)g * V + v];
    while (cur != NONE) { cur = par[cur]; ++levels; }
  }
  levels_out[g] = levels;
}

// The same paths downwards, as a descent must read them: the root action's
// child, then the chosen slot's child of every node passed (slots [B, V, D],
// NONE ends a path).  Writes the node each path ends in.
__global__ void child_chase_kernel(const int* root_child,
                                   const int* edge_child, const int* actions,
                                   const int* slots, int M, int K, int A,
                                   int V, int D, int* ends_out) {
  const int g = blockIdx.x;
  const int* child = edge_child + (size_t)g * M * K;
  for (int v = 0; v < V; ++v) {
    const int a = actions[(size_t)g * V + v];
    const int* path = slots + ((size_t)g * V + v) * D;
    int cur = a == NONE ? 0 : root_child[(size_t)g * A + a];
    for (int i = 0; i < D && path[i] != NONE; ++i)
      cur = child[(size_t)cur * K + path[i]];
    ends_out[(size_t)g * V + v] = cur;
  }
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
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        descend_hbm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(4 * sizeof(float) * ROOT_STAGE_MAX));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int cap = A < ROOT_STAGE_MAX ? A : ROOT_STAGE_MAX;
  descend_hbm_kernel<<<B, DESCEND_THREADS, 4 * sizeof(float) * cap,
                       (cudaStream_t)stream>>>(
      t, p, cap, (int*)leaves, (unsigned char*)created);
  return (int)cudaGetLastError();
}

extern "C" int tak_expand_backup_wave_hbm(
    int B, int M, int K, int A, int V,
    void* parent, void* parent_slot, void* parent_action, void* expanded,
    void* edge_action, void* edge_prior, void* edge_child, void* edge_n,
    void* edge_virt, void* edge_w, void* root_n, void* root_virt,
    void* root_w, void* n0, void* virt0,
    void* leaves, void* topk_vals, void* topk_aidx, void* results,
    void* values, void* to_move, void* scratch, void* stream) {
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
  t.node_virt = nullptr;
  PendingWave pd;
  pd.leaves = (const int*)leaves; pd.topk_vals = (const float*)topk_vals;
  pd.topk_aidx = (const int*)topk_aidx; pd.results = (const int*)results;
  pd.values = (const float*)values; pd.to_move = (const int*)to_move;
  const Dims p = {B, M, K, A, V, 0.0f, 0.0f};
  // with a scratch buffer (tak_backup_scratch_bytes) no shared memory
  const size_t bytes =
      scratch == nullptr ? backup_smem_bytes<PATH_CAP>(V) : 0;
  static size_t sized = 48 * 1024;
  if (bytes > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_backup_hbm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    sized = bytes;
  }
  expand_backup_hbm_kernel<<<B, BACKUP_THREADS, bytes,
                             (cudaStream_t)stream>>>(t, pd, p,
                                                     (int*)scratch);
  return (int)cudaGetLastError();
}

// The bytes of global scratch per game that tak_expand_backup_wave_hbm
// needs at wave V, written to *bytes_out (a host long long): 0 where the
// block's shared memory (what the card opts in to, less the kernel's static
// shared memory) holds the wave's recorded paths.
extern "C" int tak_backup_scratch_bytes(int V, void* bytes_out) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, expand_backup_hbm_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = backup_smem_bytes<PATH_CAP>(V);
  *(long long*)bytes_out =
      bytes + attr.sharedSizeBytes > (size_t)optin ? (long long)bytes : 0;
  return 0;
}

extern "C" int tak_parent_chase(int B, int M, int V, void* parent,
                                void* leaves, void* levels, void* stream) {
  parent_chase_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
      (const int*)parent, (const int*)leaves, M, V, (int*)levels);
  return (int)cudaGetLastError();
}

extern "C" int tak_child_chase(int B, int M, int K, int A, int V, int D,
                               void* root_child, void* edge_child,
                               void* actions, void* slots, void* ends,
                               void* stream) {
  child_chase_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
      (const int*)root_child, (const int*)edge_child, (const int*)actions,
      (const int*)slots, M, K, A, V, D, (int*)ends);
  return (int)cudaGetLastError();
}
