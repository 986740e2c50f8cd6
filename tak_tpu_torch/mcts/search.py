"""Batched MCTS with PUCT, virtual loss and wave evaluation.

Counterpart of `tak_tpu/mcts/search.py`, with its three descent paths
named as there (`SearchConfig.backend`, `MCTS.tier`):

  * "pallas", the pool tier (`tree_kernels.py`): every wave runs one
    merged backup+descend kernel, the fused leaf step, `observe` and the
    network, and the masked top-K; each chunk of waves ends with an
    expand+backup flush.  Supports node recycling.
  * "pallas_hbm", the large-tree tier (`tree_kernels_hbm.py`, pools up to
    140,000 nodes, no recycling; the single-game `Player`): every wave is
    descend -> step/evaluate/top-K -> expand+backup, not pipelined.
  * "xla", the staggered descent in plain PyTorch (`_descend_xla`,
    `_write_and_expand`, `_backup_xla`), the reference's vmapped
    `lax.while_loop` path with a leading game axis: all `wave_size`
    descents of a game advance one tree level per iteration, cursor v
    starting at iteration v, so each sees the virtual marks of the
    descents before it.  Gumbel root search runs on this path only.

"auto" follows the reference's rule (search.py:254-259): the pool tier
when the tree passes `fits_in_vmem`, else the large-tree tier when not
recycling and the pool is within `MAX_HBM_NODES`, else "xla"; with one
departure: a recycled pool that the pool tier's kernels take
(`pool_kernels_take`) runs there whatever the TPU's VMEM budget says
(8x8's 65,216 root actions, where the reference takes "xla").
`gumbel_m > 0` always takes "xla".  A tier is chosen from the
configuration alone, never because a kernel failed.  Search semantics
follow `alpha-tak/src/search/mcts.rs` as the JAX package does:
C(N) = ln((1+N+500)/500) + 4, virtual visits counted as losses, last-max
ties, terminal leaves backing up the anchored outcome.

On the "xla" path every scatter goes through `_put`: a write that the
reference drops (`mode="drop"` at index M or A) writes nothing, so the
trees equal the reference's field for field.  Its loops read their
condition on the host only every `_CHECK_EVERY` iterations: an iteration
after a game's end changes nothing (no cursor is live, every write is
dropped).  On the card each descent iteration is the replay of a CUDA
graph of the same operations (some 400 small ones; eager, the host's
launches made a reference-config wave 2.2 s).  The leaf states come from
the port's fused step (kernel #1 on the card), the same function as the
reference's XLA step.

Two options of the reference change how a wave's leaves get their legal
moves and top-K priors on the kernel tiers:

  * `fused_leaf_legal`: the leaf step is the fused step that also emits
    the packed legal bits (`engine/legal_bits.py` `step_legal`), and the
    top-K reads the words (`legal_topk`; `masked_topk_packed` under a
    packed `topk_impl`) instead of a dense legal mask.  The trees are
    identical either way.  The reference takes this path only when B*V is
    a multiple of 128, a TPU lane rule; the port's kernel has no such rule
    and applies at any row count.  On a card with the exact top-K and
    K <= 128 the leaves always take this path (the top-K is then the
    kernel `csrc/legal_topk.cu`, which reads the words), so there the
    option changes nothing; on the CPU it picks the words or the dense
    mask.
    The "xla" path ignores it, as the reference's does.
  * `topk_impl`: "exact", or the one-int32-key "packed" / "packedq" top-K
    (`masked_topk`), which keep their torch ops on every device.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import cached_property

import torch

from ..engine.legal_bits import (
    LEGAL_TOPK_MAX_K,
    legal_topk,
    masked_topk_packed,
)
from ..parallel.mesh import gather_rows, shard_rows
from ..types import ONGOING, GameState, result_winner
from ..utils.profiling import count, span
from .tree import NONE, TENSOR_FIELDS, Tree, init_tree, root_visit_counts
from .tree_kernels import (
    Pending,
    _c_puct,
    _last_argmax,
    backup_descend_wave,
    expand_backup_wave,
    fits_in_vmem,
    pool_kernels_take,
)
from .tree_kernels_hbm import (
    descend_wave_hbm,
    expand_backup_wave_hbm,
    fits_hbm,
)

EXPLORATION_BASE = 500.0
EXPLORATION_INIT = 4.0


@dataclass(frozen=True)
class SearchConfig:
    num_sims: int = 10_000      # rollouts per move (self_play.rs:12)
    wave_size: int = 8          # descents per game between NN evals
    max_children: int = 128     # K: stored edges per non-root node
    node_budget: int | None = None  # tree capacity; default fits num_sims
    exploration_base: float = EXPLORATION_BASE
    exploration_init: float = EXPLORATION_INIT
    # descent path: "auto" | "xla" | "pallas" (pool tier) | "pallas_hbm"
    # (large-tree tier); the reference's names, see the module docstring
    backend: str = "auto"
    # top-K child selection: "exact" | "packed" | "packedq" (see
    # masked_topk).  The reference's "auto" is packedq on the TPU and exact
    # on the CPU; the port's "auto" is "exact" on both devices: its default
    # trees stay bitwise those of the exact top-K until a measurement on
    # the card (PERF.md) argues for a change.
    topk_impl: str = "auto"
    # take the leaves' legal moves from the fused step as packed words and
    # run the top-K on the words, instead of a dense legal mask per wave
    # (on a card with the exact top-K and K <= 128 they always are)
    fused_leaf_legal: bool = False
    # node recycling: a create in a full pool evicts the coldest unpinned
    # childless node instead of degrading to a parent re-eval
    recycle: bool = False
    # reroot-time carry compaction: keep at most this many carried nodes
    reroot_keep: int | None = None
    # run the waves in chunks of ~this many sims (rounded up to whole
    # waves), each ending with the expand+backup flush
    scan_chunk: int | None = None
    # Gumbel root selection (Danihelka et al. 2022): 0 = off.  When > 0,
    # root descents follow a sequential-halving schedule over the top
    # `gumbel_m` actions scored by g + log pi + sigma(q) (run_sims_gumbel,
    # select_moves_gumbel); non-root selection stays PUCT; "xla" path only
    gumbel_m: int = 0
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0

    @property
    def num_waves(self) -> int:
        return -(-self.num_sims // self.wave_size)

    @property
    def max_nodes(self) -> int:
        return self.node_budget or (self.num_waves * self.wave_size + 2)


# int64 keys the exact top-K forms at once: one block of rows at 6x6's
# 8,192 x 9,036, two at 8x8's 8,192 x 65,216 (4.3 GB of keys a block)
TOPK_KEYS = 1 << 28


def masked_topk(policy, legal, k: int, impl: str = "exact"):
    """(vals, action_ids) of the top-k legal policy entries per row.

    `policy` must be a softmax (entries in [0, 1]).  impl="exact" is
    `top_k(where(legal, policy, -1), k)` with ties to the LOWER index, as
    `jax.lax.top_k`: one int64 key per entry (order-preserving float bits
    above the reversed index) makes every key distinct, so the order is
    deterministic; pad slots return -1 (and the lowest illegal ids).

    impl="packed" / "packedq" pack a quantized prior and the action id into
    ONE int32 key, `round(policy * (2^q - 1)) << idx_bits | id` with
    q = min(17, 31 - idx_bits) bits (17 at 6x6), illegal entries INT32_MIN,
    and run one integer top-k.  "packed" then gathers the exact float32
    priors by id; "packedq" decodes the quantized priors from the keys.
    Deviations from "exact": which action wins a tie below the quantum
    (2^-17 at 6x6) at the K boundary, ties between equal quanta go to the
    HIGHER id, and (packedq) priors carry an absolute error below 2^-17.
    Pad slots return vals = -1, id 0.  Same values and ids as the JAX
    package's function of the same name.

    "exact" takes the rows in blocks of at most TOPK_KEYS keys (at least
    one row a block); rows are independent, so the result is the unsplit
    one bit for bit."""
    if impl == "exact" and policy.dim() == 2:
        per = max(1, TOPK_KEYS // policy.shape[-1])
        if policy.shape[0] > per:
            parts = [masked_topk(policy[i:i + per], legal[i:i + per], k)
                     for i in range(0, policy.shape[0], per)]
            return (torch.cat([v for v, _ in parts]),
                    torch.cat([a for _, a in parts]))
    if impl == "exact":
        masked = torch.where(legal, policy.float(),
                             torch.full_like(policy, -1.0,
                                             dtype=torch.float32))
        A = masked.shape[-1]
        if A >= 1 << 20:
            raise ValueError(f"action space {A} too wide for masked_topk")
        bits = masked.contiguous().view(torch.int32)
        key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).long()
        rev_idx = (1 << 20) - 1 - torch.arange(A, device=masked.device)
        top = torch.topk((key << 20) | rev_idx, k, dim=-1).indices
        return masked.gather(-1, top), top.to(torch.int32)
    if impl not in ("packed", "packedq"):
        raise ValueError(f"unknown topk impl {impl!r}")
    policy = policy.float()
    A = policy.shape[-1]
    idx_bits = max(1, (A - 1).bit_length())
    q_bits = min(17, 31 - idx_bits)
    if q_bits < 8:
        raise ValueError(f"action space {A} too wide for packed topk")
    scale = float((1 << q_bits) - 1)
    q = torch.round(policy * scale).to(torch.int32)
    iota = torch.arange(A, dtype=torch.int32, device=policy.device)
    key = torch.where(legal, (q << idx_bits) | iota,
                      torch.full_like(q, -(1 << 31)))
    top = torch.topk(key, k, dim=-1).values
    ok = top >= 0                       # legal keys are never negative
    aidx = torch.where(ok, top & ((1 << idx_bits) - 1), torch.zeros_like(top))
    if impl == "packedq":
        vals = (top >> idx_bits).float() / scale
    else:
        vals = policy.gather(-1, aidx.long())
    return torch.where(ok, vals, torch.full_like(vals, -1.0)), aidx


def _gamma_fixed(gen, alpha: float, shape, device, iters: int = 4):
    """Gamma(alpha) by Marsaglia-Tsang squeeze sampling unrolled to `iters`
    tries (no data-dependent loop); stragglers take the mean.  alpha < 1
    uses the boost Gamma(a) = Gamma(a+1) * U^(1/a)."""
    boost_needed = alpha < 1.0
    a = alpha + 1.0 if boost_needed else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.full(shape, d, dtype=torch.float32, device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(iters):
        x = torch.randn(shape, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device).clamp(min=1e-12)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-12)))
        out = torch.where(ok & ~accepted, d * v, out)
        accepted = accepted | ok
    if boost_needed:
        boost = torch.rand(shape, generator=gen, device=device).clamp(
            min=1e-12) ** (1.0 / alpha)
        out = out * boost
    return out


def _row_draw(draw, shape, mesh):
    """draw(shape) for this rank's rows: with `mesh`, its `shard_rows` of
    draw(shape) over the whole batch (`shape` holds one rank's rows)."""
    if mesh is None:
        return draw(tuple(shape))
    return shard_rows(mesh, draw((shape[0] * mesh.world,) + tuple(shape[1:])))


# the "xla" path's loops read their condition on the host every this many
# iterations (the descent only once its V cursors have all started)
_CHECK_EVERY = 8


def _put(flat, idx, val, keep, add: bool = False) -> None:
    """Scatter into the rows of `flat` ([N, ...], a view of a tree field) at
    the flat indices `idx` where `keep`; elsewhere nothing is written (the
    reference's `mode="drop"`).  An add (`index_add_`: duplicates sum, on
    the card in any order) adds 0 where not kept, at the entry's own index
    clamped into range, so that no one address collects them; a set sends
    what is not kept to a trash row past the end of a padded copy, which is
    sliced off, so its indices must be unique or carry equal values.  A
    Python number `val` is filled on the device (a host tensor would be
    copied over, and such a copy waits for the stream)."""
    idx = idx.reshape(-1).long()
    keep = keep.reshape(-1)
    row = tuple(flat.shape[1:])
    shape = keep.shape + row
    k = keep.view(keep.shape + (1,) * len(row))
    n = flat.shape[0]
    if add:
        if isinstance(val, torch.Tensor):
            val = torch.where(k, val.to(flat.dtype).reshape(shape),
                              torch.zeros((), dtype=flat.dtype,
                                          device=flat.device))
        else:
            val = k.expand(shape).to(flat.dtype) * val
        flat.index_add_(0, idx.clamp(0, n - 1), val)
        return
    if isinstance(val, torch.Tensor):
        val = val.to(flat.dtype).reshape(shape)
    else:
        val = torch.full(shape, val, dtype=flat.dtype, device=flat.device)
    pad = torch.cat([flat, flat.new_zeros((1,) + row)])
    pad.index_put_((torch.where(keep, idx, n),), val)
    flat.copy_(pad[:n])


@dataclass
class _Cursors:
    """The "xla" descent's per-wave cursor state (`MCTS._descent_state`)."""

    cur: torch.Tensor        # long [B, V] node of each cursor (NONE: done)
    nv: torch.Tensor         # long [B, V] carried N(cur)
    leaf: torch.Tensor       # long [B, V] resolved leaf (NONE: none yet)
    created: torch.Tensor    # bool [B, V]
    t: torch.Tensor          # long [] iteration
    off: torch.Tensor        # long [] sim index of descent 0 (Gumbel)
    iota: torch.Tensor       # long [V]
    gumbel: torch.Tensor | None

    def clone(self) -> "_Cursors":
        return _Cursors(**{f.name: (None if getattr(self, f.name) is None
                                    else getattr(self, f.name).clone())
                           for f in dataclasses.fields(self)})


class MCTS:
    """Batched search bound to an engine and an evaluation function.

    eval_fn(params, states [R]) -> (policy [R, A] softmax, value [R]).
    `prepare_root` must run on fresh trees before `run_sims`.  The tree
    is updated in place; methods return it for chaining."""

    def __init__(self, engine, eval_fn, config: SearchConfig):
        self.engine = engine
        self.eval_fn = eval_fn
        self.config = config
        self.tier = self._resolve_tier()
        if config.topk_impl not in ("auto", "exact", "packed", "packedq"):
            raise ValueError(f"unknown topk_impl {config.topk_impl!r}")
        self.topk_impl = ("exact" if config.topk_impl == "auto"
                          else config.topk_impl)
        self._xla_states: dict = {}   # cursor tensors by shape ("xla")
        self._xla_graphs: dict = {}   # captured descent iterations
        # on the card, replay the "xla" descent iteration as a CUDA graph
        # (False: run it eagerly, as on the CPU; the two give equal trees)
        self._graphs = True
        self._seq_tensors: dict = {}  # the Gumbel schedule by device

    def _resolve_tier(self) -> str:
        """"pool", "hbm" or "xla": which path the waves take."""
        cfg = self.config
        if cfg.backend not in ("auto", "xla", "pallas", "pallas_hbm"):
            raise ValueError(f"unknown search backend {cfg.backend!r}")
        if cfg.gumbel_m > 0 and cfg.backend.startswith("pallas"):
            raise ValueError(
                "gumbel root selection runs on the xla descent path only")
        if cfg.recycle and cfg.backend == "pallas_hbm":
            raise ValueError(
                "node recycling runs on the pool tier or the xla path; the "
                "large-tree tier does not support it")
        if cfg.gumbel_m > 0 or cfg.backend == "xla":
            return "xla"
        if cfg.backend == "pallas":
            return "pool"
        if cfg.backend == "pallas_hbm":
            return "hbm"
        if fits_in_vmem(cfg.max_nodes, cfg.max_children,
                        self.engine.num_actions):
            return "pool"
        # the budget is the TPU's VMEM; on the card the pool tier takes any
        # recycled pool its kernels take, whatever the root's width (8x8's
        # 65,216 actions: the legal ones are staged in shared memory as
        # far as it holds them)
        if pool_kernels_take(cfg.max_nodes, cfg.max_children, cfg.wave_size,
                             cfg.recycle):
            return "pool"
        if not cfg.recycle and fits_hbm(cfg.max_nodes):
            return "hbm"
        return "xla"

    def init_batch(self, root_states: GameState) -> Tree:
        return init_tree(self.engine, root_states, self.config.max_nodes,
                         self.config.max_children)

    @torch.no_grad()
    def prepare_root(self, params, tree: Tree) -> Tree:
        """Expand unexpanded roots with one evaluation (rollout #1)."""
        with span("search.prepare_root"):
            need = ~tree.expanded[:, 0]
            with span("search.root_need", sync=True):
                if not bool(need.any()):
                    return tree
            root_states = tree.state[:, 0]
            policy, _ = self.eval_fn(params, root_states)
            legal = self.engine.legal_mask(root_states)
            m = need[:, None]
            tree.root_prior.copy_(torch.where(m, policy.float(),
                                              tree.root_prior))
            tree.root_legal.copy_(torch.where(m, legal, tree.root_legal))
            tree.n0 += need.int()
            tree.expanded[:, 0] |= need
            return tree

    def add_noise(self, gen, tree: Tree, alpha: float, ratio: float,
                  apply_mask, mesh=None) -> Tree:
        """Dirichlet root noise: p <- ratio*noise + (1-ratio)*p.  With
        `mesh` the tree holds this rank's games of the batch, and the
        gammas are drawn for the whole batch and cut to its rows, so that
        they are the draws of one process holding every game."""
        gammas = _row_draw(
            lambda shape: _gamma_fixed(gen, alpha, shape,
                                       tree.root_prior.device),
            tree.root_prior.shape, mesh)
        gammas = torch.where(tree.root_legal, gammas, torch.zeros_like(gammas))
        noise = gammas / torch.clamp(gammas.sum(-1, keepdim=True), min=1e-30)
        mixed = ratio * noise + (1.0 - ratio) * tree.root_prior
        use = tree.root_legal & apply_mask.to(tree.root_legal.device)[:, None]
        tree.root_prior.copy_(torch.where(use, mixed, tree.root_prior))
        return tree

    # -- waves ----------------------------------------------------------------

    def _leaf_step_inputs(self, tree: Tree, leaves):
        """(parent states, actions, enabled), flat [B*V]: what one fused
        step turns into the leaves' states.  A root leaf (index 0) is
        disabled, so it rides the freeze path and comes back as the root
        state."""
        B, V = leaves.shape
        b = torch.arange(B, device=leaves.device)[:, None]
        lv = leaves.long()
        p = torch.where(lv == 0, torch.zeros_like(lv),
                        torch.clamp(tree.parent[b, lv], min=0).long())
        parents = tree.state.map(
            lambda x: x[b, p].reshape((B * V,) + tuple(x.shape[2:])))
        acts = torch.clamp(tree.parent_action[b, lv], min=0).reshape(-1)
        return parents, acts, (lv != 0).reshape(-1)

    def _leaf_words(self, device) -> bool:
        """Whether the leaf step emits the packed legal words: with
        `fused_leaf_legal`, and on a card whenever the top-K is exact and
        K is one the legal top-K kernel takes (it reads the words; a wider
        K, which the tree kernels allow, keeps the dense mask)."""
        return self.config.fused_leaf_legal or (
            device.type == "cuda" and self.topk_impl == "exact"
            and self.config.max_children <= LEGAL_TOPK_MAX_K)

    def _leaf_states_of(self, tree: Tree, leaves):
        """Every leaf's state with one fused step: step(state[parent],
        parent_action).  Returns (flat states [B*V], the leaves' packed
        legal words (place, spread) where `_leaf_words`, else None)."""
        with span("search.leaf_step"):
            inputs = self._leaf_step_inputs(tree, leaves)
            if self._leaf_words(leaves.device):
                flat, place, spread = self.engine.step_legal(*inputs)
                return flat, (place, spread)
            return self.engine.step(*inputs), None

    def _write_nodes(self, tree: Tree, leaves, created, flat_states: GameState,
                     leaf_results) -> None:
        """Write created nodes' states and results (unique indices)."""
        B, V = leaves.shape
        with span("search.write_nodes"):
            with span("search.nonzero", sync=True):
                g, v = torch.nonzero(created, as_tuple=True)
            idx = leaves[g, v].long()
            for f in ("stacks", "heights", "tops", "to_move", "ply",
                      "stones", "caps", "half_komi", "reversible", "result"):
                src = getattr(flat_states, f)
                getattr(tree.state, f)[g, idx] = src.reshape(
                    (B, V) + tuple(src.shape[1:]))[g, v]
            tree.result[g, idx] = leaf_results[g, v]

    @torch.no_grad()
    def _eval_and_topk(self, params, tree: Tree, leaves, created) -> Pending:
        """Step + write leaf nodes + evaluate + top-K legal priors; returns
        what the next expand+backup consumes."""
        B, V = leaves.shape
        K = self.config.max_children
        flat, fused_legal = self._leaf_states_of(tree, leaves)
        with span("search.eval"):
            policy, value = self.eval_fn(params, flat)
        leaf_results = flat.result.reshape(B, V)
        with span("search.legal_topk"):
            if (fused_legal is not None and self.topk_impl == "exact"
                    and K <= LEGAL_TOPK_MAX_K):
                vals, aidx = legal_topk(self.engine, policy, *fused_legal, K)
            elif fused_legal is not None:
                vals, aidx = masked_topk_packed(self.engine, policy,
                                                *fused_legal, K)
            else:
                legal = self.engine.legal_mask(flat)
                vals, aidx = masked_topk(policy, legal, K, self.topk_impl)
        self._write_nodes(tree, leaves, created, flat, leaf_results)
        return Pending(
            leaves=leaves.to(torch.int32).contiguous(),
            topk_vals=vals.reshape(B, V, K).contiguous(),
            topk_aidx=aidx.reshape(B, V, K).contiguous(),
            results=leaf_results.contiguous(),
            values=value.float().reshape(B, V).contiguous(),
            to_move=flat.to_move.reshape(B, V).contiguous(),
            valid=1,
        )

    def _wave(self, wave, *args):
        """`wave(*args)`, one wave of any tier, inside its `search.wave`
        span and counted in `search.waves`."""
        with span("search.wave"):
            out = wave(*args)
        count("search.waves")
        return out

    def _kernel_args(self):
        cfg = self.config
        return dict(base=float(cfg.exploration_base),
                    init=float(cfg.exploration_init), recycle=bool(cfg.recycle))

    def _wave_pipelined(self, params, tree: Tree, pending: Pending) -> Pending:
        """Apply the previous wave's expansions and backups fused with this
        wave's descents (one merged kernel), then step/evaluate the new
        leaves.  Callers flush the final pending with the expand+backup."""
        with span("search.tree_kernel"):
            leaves, created = backup_descend_wave(tree, pending,
                                                  **self._kernel_args())
        return self._eval_and_topk(params, tree, leaves, created)

    def _wave_hbm(self, params, tree: Tree) -> None:
        """One large-tier wave: descend -> step/evaluate/top-K ->
        expand+backup (`tak_tpu` search.py:860-876)."""
        cfg = self.config
        with span("search.tree_kernel"):
            leaves, created = descend_wave_hbm(
                tree, cfg.wave_size, base=float(cfg.exploration_base),
                init=float(cfg.exploration_init))
        pending = self._eval_and_topk(params, tree, leaves, created)
        with span("search.flush"):
            expand_backup_wave_hbm(tree, pending)

    # -- the "xla" path: staggered descents in plain PyTorch ---------------

    def _q_u(self, n, virt, w, prior, npf):
        """Q with virtual losses plus the PUCT U term, in the reference's
        order of operations ([..., K] rows; npf = N(parent) as float32
        broadcast against them)."""
        cfg = self.config
        tot = (n + virt).float()
        q = torch.where(tot > 0, (w - virt.float()) / torch.clamp(tot, min=1.0),
                        torch.zeros_like(tot))
        u = (_c_puct(npf, cfg.exploration_base, cfg.exploration_init)
             * prior * torch.sqrt(npf) / (1.0 + tot))
        return q + u

    def _select_root(self, tree: Tree):
        """Dense PUCT over the full action space [B, A] -> [B]."""
        n0 = (tree.n0 + tree.virt0).float()[:, None]
        s = self._q_u(tree.root_n, tree.root_virt, tree.root_w,
                      tree.root_prior, n0)
        return _last_argmax(torch.where(tree.root_legal, s,
                                        torch.full_like(s, float("-inf"))))

    def _select_edges(self, tree: Tree, bv, ci, nv):
        """PUCT over the K edge rows of nodes `ci` [B, V]; nv = N(ci)."""
        s = self._q_u(tree.edge_n[bv, ci], tree.edge_virt[bv, ci],
                      tree.edge_w[bv, ci], tree.edge_prior[bv, ci],
                      nv.float()[..., None])
        return _last_argmax(torch.where(tree.edge_action[bv, ci] != NONE, s,
                                        torch.full_like(s, float("-inf"))))

    def _pick_victims(self, tree: Tree, protect, k: int):
        """The k coldest eviction candidates per game ([B, k] ids, [B, k]
        valid): childless, unpinned, non-root and not in `protect` ([B, P]
        node ids; M entries ignored), by ascending node_n, ties to the
        LOWEST index (`jax.lax.top_k(-score)`): one int64 key per node,
        score * (M + 1) + index, makes every key distinct."""
        B, M = tree.node_n.shape
        dev = tree.node_n.device
        prot = torch.zeros((B, M + 1), dtype=torch.bool, device=dev)
        prot.scatter_(1, protect.clamp(0, M).long(), True)
        idx = torch.arange(M, device=dev)
        cand = ((tree.child_count == 0) & (tree.node_virt == 0) & (idx > 0)
                & ~prot[:, :M])
        score = torch.where(cand, tree.node_n.long(),
                            torch.full_like(tree.node_n, 2 ** 30).long())
        key = torch.topk(score * (M + 1) + idx, k, dim=1, largest=False,
                         sorted=True).values
        return key % (M + 1), key // (M + 1) < 2 ** 30

    def _evict(self, tree: Tree, bv, vid) -> None:
        """Detach victims `vid` ([B, k]; M = unused) from their parents and
        reset them to unallocated leaves; the parent edge keeps its
        statistics.  A victim without a parent link cannot occur (every
        allocated node is attached); its writes are skipped."""
        B, M, K = tree.edge_n.shape
        A = tree.root_n.shape[1]
        used = vid < M
        gi = bv * M + vid.clamp(0, M - 1)
        pv = torch.where(used, tree.parent.view(-1)[gi].long(), M)
        sv = tree.parent_slot.view(-1)[gi].long()
        av = torch.where(used, tree.parent_action.view(-1)[gi].long(), A)
        root_edge = used & (pv == 0) & (sv == NONE)
        is_edge = used & ~root_edge & (pv >= 0) & (sv >= 0)
        _put(tree.edge_child.view(-1), (bv * M + pv) * K + sv, NONE, is_edge)
        _put(tree.root_child.view(-1), bv * A + av, NONE,
             root_edge & (av >= 0))
        _put(tree.child_count.view(-1), bv * M + pv, -1, used & (pv >= 0),
             add=True)
        _put(tree.expanded.view(-1), gi, False, used)
        _put(tree.node_n.view(-1), gi, 0, used)

    def _descend_xla(self, tree: Tree, gumbel=None, sim_offset: int = 0):
        """wave_size staggered descents per game (`tak_tpu` search.py:
        470-640), the tree updated in place.  With `gumbel` [B, A] the root
        follows the sequential-halving schedule (descent t uses sim index
        sim_offset + t).  Returns (leaves [B, V] int32, created [B, V]).

        Iteration t < V starts cursor t at the root, then every iteration
        advances each live cursor one level (`_descent_step`).  The loop
        ends once no cursor is live, read every `_CHECK_EVERY` iterations.
        On the card each iteration is a CUDA graph replay (`_step_runner`);
        the graphs run the same operations as the CPU."""
        V = self.config.wave_size
        st = self._descent_state(tree, gumbel, sim_offset)
        start = self._step_runner(tree, st, True)
        step = self._step_runner(tree, st, False)
        for _ in range(V):
            start()
        while True:
            with span("search.descent_live", sync=True):
                if not bool((st.cur != NONE).any()):
                    break
            for _ in range(_CHECK_EVERY):
                step()
        return st.leaf.clamp(min=0).to(torch.int32), st.created.clone()

    def _descent_state(self, tree: Tree, gumbel, sim_offset: int):
        """The cursors of a wave ([B, V]: node, carried N, resolved leaf,
        created), the iteration counter t and the sim offset as device
        scalars, and the Gumbel sample: one set of tensors a shape, reset
        here, so that captured graphs keep their addresses."""
        B, V = tree.n0.shape[0], self.config.wave_size
        dev = tree.n0.device
        key = (B, V, str(dev), gumbel is not None)
        st = self._xla_states.get(key)
        if st is None:
            st = _Cursors(
                cur=torch.empty((B, V), dtype=torch.long, device=dev),
                nv=torch.empty((B, V), dtype=torch.long, device=dev),
                leaf=torch.empty((B, V), dtype=torch.long, device=dev),
                created=torch.empty((B, V), dtype=torch.bool, device=dev),
                t=torch.empty((), dtype=torch.long, device=dev),
                off=torch.empty((), dtype=torch.long, device=dev),
                iota=torch.arange(V, device=dev),
                gumbel=(torch.empty_like(tree.root_w) if gumbel is not None
                        else None))
            self._xla_states[key] = st
        st.cur.fill_(NONE)
        st.nv.zero_()
        st.leaf.fill_(NONE)
        st.created.zero_()
        st.t.zero_()
        st.off.fill_(sim_offset)
        if gumbel is not None:
            st.gumbel.copy_(gumbel)
        return st

    def _step_runner(self, tree: Tree, st, start: bool):
        """A function running one descent iteration on `tree`: eager on
        the CPU (or with `_graphs` off); on the card the replay of a CUDA
        graph of `_descent_step`, captured once per tree storage (a
        warm-up on copies first, so that capture records but changes
        nothing)."""
        if tree.n0.device.type != "cuda" or not self._graphs:
            return lambda: self._descent_step(tree, st, start)
        key = (start, id(st)) + tuple(getattr(tree, f).data_ptr()
                                      for f in TENSOR_FIELDS)
        have = self._xla_graphs.get(start)
        if have is None or have[0] != key:
            self._xla_graphs.pop(start, None)
            scratch = (tree.clone(), st.clone())
            side = torch.cuda.Stream(device=tree.n0.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._descent_step(*scratch, start)
            torch.cuda.current_stream().wait_stream(side)
            del scratch
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._descent_step(tree, st, start)
            self._xla_graphs[start] = (key, graph)
        return self._xla_graphs[start][1].replay

    def _descent_step(self, tree: Tree, st, start: bool) -> None:
        """One iteration of the staggered descent (`tak_tpu` search.py:
        489-634): with `start`, cursor t starts at the root; then every
        live cursor advances one level.  Device operations only."""
        cfg = self.config
        V, M, rc = cfg.wave_size, cfg.max_nodes, cfg.recycle
        B, _, K = tree.edge_n.shape
        A = tree.root_n.shape[1]
        dev = tree.n0.device
        b = torch.arange(B, device=dev)
        bv = b[:, None]

        def node(f):
            return getattr(tree, f).view(-1)

        if start:
            # ---- start cursor t at the root --------------------------------
            if st.gumbel is None:
                a0 = self._select_root(tree)
            else:
                a0 = self._select_root_gumbel(tree, st.gumbel, st.off + st.t)
            c0 = tree.root_child[b, a0].long()
            nv0 = (tree.root_n[b, a0] + tree.root_virt[b, a0]).long()
            want0 = c0 == NONE
            nf = tree.next_free.long()
            fresh0 = nf < M
            if rc:
                vict, valid = self._pick_victims(
                    tree, torch.where(st.cur != NONE, st.cur, M), 1)
                use_v0 = want0 & ~fresh0
                ok0 = want0 & (fresh0 | valid[:, 0])
                idx0 = torch.where(use_v0, vict[:, 0], nf)
                self._evict(tree, bv, torch.where(
                    (use_v0 & ok0)[:, None], vict, M))
            else:
                ok0 = want0 & fresh0
                use_v0 = torch.zeros_like(ok0)
                idx0 = nf
            # a failed create re-evaluates the root and leaves no mark
            _put(node("root_virt"), b * A + a0, 1, (c0 != NONE) | ok0,
                 add=True)
            tree.virt0 += 1
            _put(node("root_child"), b * A + a0, idx0, ok0)
            sent = b * M + idx0
            _put(node("parent"), sent, 0, ok0)
            _put(node("parent_slot"), sent, NONE, ok0)
            _put(node("parent_action"), sent, a0, ok0)
            tree.next_free += (ok0 & ~use_v0).int()
            is_t = st.iota == st.t
            st.cur.copy_(torch.where(is_t & ~ok0[:, None], c0[:, None],
                                     st.cur))
            st.nv.copy_(torch.where(is_t, nv0[:, None], st.nv))
            st.leaf.copy_(torch.where(is_t & ok0[:, None], idx0[:, None],
                                      st.leaf))
            st.created |= is_t & ok0[:, None]
            if rc:
                pin0 = torch.where(ok0, idx0, torch.where(want0, 0, M))
                _put(node("child_count"), b * M, 1, ok0, add=True)
                _put(node("node_n"), sent, tree.root_n[b, a0], ok0)
                _put(node("node_virt"), b * M + pin0, 1, pin0 < M, add=True)

        # ---- advance every live cursor one level -----------------------------
        cur, nv = st.cur, st.nv
        active = cur != NONE
        ci = cur.clamp(min=0)
        stop_here = active & ~tree.expanded[bv, ci]
        walking = active & ~stop_here
        slots = self._select_edges(tree, bv, ci, nv)
        action = tree.edge_action[bv, ci, slots]
        child = tree.edge_child[bv, ci, slots].long()
        child_en = tree.edge_n[bv, ci, slots]
        child_nv = (child_en + tree.edge_virt[bv, ci, slots]).long()
        eidx = (bv * M + ci) * K + slots
        _put(node("edge_virt"), eidx, 1, walking, add=True)
        want = walking & (child == NONE)
        ranks = want.long().cumsum(1) - 1
        nf = tree.next_free.long()[:, None]
        if rc:
            # protect the nodes cursors sit on or move into; fresh slots
            # first, victims for the overflow
            vict, vvalid = self._pick_victims(tree, torch.cat([
                torch.where(active, ci, M),
                torch.where(walking & (child != NONE), child, M)], 1), V)
            vrank = ranks - (M - nf)
            use_v = want & (vrank >= 0)
            vsel = vrank.clamp(0, V - 1)
            ok = want & torch.where(use_v, vvalid.gather(1, vsel), True)
            ids = torch.where(use_v, vict.gather(1, vsel), nf + ranks)
            self._evict(tree, bv, torch.where(use_v & ok, ids, M))
        else:
            ids = nf + ranks
            ok = want & (ids < M)
            use_v = torch.zeros_like(ok)
        idxv = torch.where(ok, ids, M)
        _put(node("edge_child"), eidx, idxv, ok)
        made = bv * M + idxv
        _put(node("parent"), made, cur, ok)
        _put(node("parent_slot"), made, slots, ok)
        _put(node("parent_action"), made, action, ok)
        tree.next_free += (ok & ~use_v).sum(1).int()
        # stop at pending/terminal nodes and on fresh creations; a failed
        # create re-evaluates the parent
        stopping = stop_here | want
        new_leaf = torch.where(stop_here, cur, torch.where(ok, idxv, cur))
        if rc:
            _put(node("child_count"), bv * M + ci, 1, ok, add=True)
            _put(node("node_n"), made, child_en, ok)
            _put(node("node_virt"), bv * M + new_leaf.clamp(min=0), 1,
                 stopping & active, add=True)
        st.leaf.copy_(torch.where(stopping & active, new_leaf, st.leaf))
        st.created |= ok
        done = stopping | ~active
        st.nv.copy_(torch.where(done, nv, child_nv))
        st.cur.copy_(torch.where(done, NONE, child))
        st.t += 1

    def _write_and_expand(self, tree: Tree, leaves, created, flat, policy):
        """Write the created nodes' states and results, then install the
        top-K legal priors of every non-terminal, non-root, unexpanded leaf
        (duplicate leaves write identical rows)."""
        B, M, K = tree.edge_n.shape
        bv = torch.arange(B, device=leaves.device)[:, None]
        lv = leaves.long()
        self._write_nodes(tree, leaves, created, flat,
                          flat.result.reshape(B, -1))
        keep = ~((tree.result[bv, lv] != ONGOING) | (lv == 0)
                 | tree.expanded[bv, lv])
        with span("search.legal_topk"):
            legal = self.engine.legal_mask(flat)
            vals, aidx = masked_topk(policy, legal, K, self.topk_impl)
        ok = vals >= 0.0
        rows = bv * M + lv
        for f, v in (("edge_action", torch.where(ok, aidx,
                                                 torch.full_like(aidx, NONE))),
                     ("edge_prior", torch.where(ok, vals,
                                                torch.zeros_like(vals))),
                     ("edge_n", 0), ("edge_virt", 0), ("edge_w", 0.0),
                     ("edge_child", NONE)):
            _put(getattr(tree, f).view(B * M, K), rows, v, keep)
        _put(tree.expanded.view(-1), rows, True, keep)

    @staticmethod
    def _leaf_values(tree: Tree, leaves, to_move, value):
        """Terminal leaves back up the anchored outcome instead of the
        network value (mcts.rs:53-64)."""
        B = leaves.shape[0]
        bv = torch.arange(B, device=leaves.device)[:, None]
        res = tree.result[bv, leaves.long()]
        winner = result_winner(res)
        one = torch.ones_like(value)
        term = torch.where(winner < 0, 0.0 * one,
                           torch.where(to_move == winner, one, -one))
        return torch.where(res != ONGOING, term, value)

    def _backup_xla(self, tree: Tree, leaves, values) -> None:
        """All V backups walk up in lockstep (mcts.rs:67-91 signs)."""
        B, M, K = tree.edge_n.shape
        A = tree.root_n.shape[1]
        bv = torch.arange(B, device=leaves.device)[:, None]
        cur = leaves.long()
        if self.config.recycle:   # release the descents' in-flight pins
            _put(tree.node_virt.view(-1), bv * M + cur, -1,
                 torch.ones_like(cur, dtype=torch.bool), add=True)
        sign = torch.full(tuple(cur.shape), -1.0, device=cur.device)
        i = 0
        while True:
            if i > 0 and i % _CHECK_EVERY == 0:
                with span("search.backup_live", sync=True):
                    if not bool((cur != NONE).any()):
                        break
            alive = cur != NONE
            gi = bv * M + cur.clamp(min=0)
            p = tree.parent.view(-1)[gi].long()
            s = tree.parent_slot.view(-1)[gi].long()
            a = tree.parent_action.view(-1)[gi].long()
            root_edge = alive & (p == 0) & (s == NONE) & (a >= 0)
            is_edge = alive & (p != NONE) & ~root_edge & (s >= 0)
            ri = bv * A + a
            ei = (bv * M + p) * K + s
            add = sign * values
            _put(tree.root_n.view(-1), ri, 1, root_edge, add=True)
            _put(tree.root_virt.view(-1), ri, -1, root_edge, add=True)
            _put(tree.root_w.view(-1), ri, add, root_edge, add=True)
            _put(tree.edge_n.view(-1), ei, 1, is_edge, add=True)
            _put(tree.edge_virt.view(-1), ei, -1, is_edge, add=True)
            _put(tree.edge_w.view(-1), ei, add, is_edge, add=True)
            at_root = (alive & (cur == 0)).sum(1).int()
            tree.n0 += at_root
            tree.virt0 -= at_root
            cur = torch.where(alive, p, NONE)
            sign = -sign
            i += 1

    @torch.no_grad()
    def _wave_xla(self, params, tree: Tree, gumbel=None, wave_idx: int = 0):
        """One "xla" wave: descents, the leaves' fused step, the network,
        node writes and expansion, then the backups."""
        B, V = tree.n0.shape[0], self.config.wave_size
        with span("search.tree_kernel"):
            leaves, created = self._descend_xla(tree, gumbel, wave_idx * V)
        with span("search.leaf_step"):
            flat = self.engine.step(*self._leaf_step_inputs(tree, leaves))
        with span("search.eval"):
            policy, value = self.eval_fn(params, flat)
        self._write_and_expand(tree, leaves, created, flat, policy)
        values = self._leaf_values(tree, leaves, flat.to_move.reshape(B, V),
                                   value.float().reshape(B, V))
        with span("search.flush"):
            self._backup_xla(tree, leaves, values)

    # -- Gumbel root search (sequential halving), "xla" path -------------------

    @cached_property
    def _considered_seq(self) -> tuple:
        """Scheduled visit count for each root-descent index: sequential
        halving over `gumbel_m` actions across the whole sim budget."""
        cfg = self.config
        n = cfg.num_waves * cfg.wave_size
        m = max(2, min(cfg.gumbel_m, self.engine.num_actions))
        phases = max(1, math.ceil(math.log2(m)))
        seq: list[int] = []
        visits = 0
        considered = m
        while len(seq) < n:
            extra = max(1, n // (phases * considered))
            for _ in range(extra):
                seq.extend([visits] * considered)
                visits += 1
                if len(seq) >= n:
                    break
            considered = max(2, considered // 2)
        return tuple(seq[:n])

    def _gumbel_scores(self, tree: Tree, gumbel):
        """g + log(prior) + sigma(completed q) over the root actions
        [B, A]; sigma(q) = (c_visit + max_a N(a)) * c_scale * q, unvisited
        actions completed with the visit-weighted root value."""
        cfg = self.config
        n = tree.root_n.float()
        visited = tree.root_n > 0
        q = torch.where(visited, tree.root_w / torch.clamp(n, min=1.0),
                        torch.zeros_like(n))
        total = n.sum(-1, keepdim=True)
        v_mix = torch.where(
            total > 0, tree.root_w.sum(-1, keepdim=True)
            / torch.clamp(total, min=1.0), torch.zeros_like(total))
        qc = torch.where(visited, q, v_mix)
        maxn = tree.root_n.max(-1, keepdim=True).values.float()
        sigma = (cfg.gumbel_c_visit + maxn) * cfg.gumbel_c_scale
        logp = torch.log(torch.clamp(tree.root_prior, min=1e-30))
        scores = gumbel + logp + sigma * qc
        return torch.where(tree.root_legal, scores,
                           torch.full_like(scores, float("-inf")))

    def _select_root_gumbel(self, tree: Tree, gumbel, sim_idx):
        """Root action for descent `sim_idx` (a device scalar): the best
        score among actions whose visit count (in flight included) matches
        the schedule, else the least-visited best-scored one."""
        dev = tree.root_n.device
        seq = self._seq_tensors.get(str(dev))
        if seq is None:
            seq = torch.as_tensor(self._considered_seq, device=dev)
            self._seq_tensors[str(dev)] = seq
        # a one-element index: a 0-dim one would be read on the host
        target = seq[torch.clamp(sim_idx, max=seq.shape[0] - 1).view(1)]
        nvis = tree.root_n + tree.root_virt
        scores = self._gumbel_scores(tree, gumbel)
        on = tree.root_legal & (nvis == target)
        sel = torch.where(on, scores, torch.full_like(scores, float("-inf")))
        fallback = scores - 1e7 * nvis.float()
        return _last_argmax(torch.where(on.any(-1, keepdim=True), sel,
                                        fallback))

    def run_sims_gumbel(self, params, tree: Tree, gen, mesh=None):
        """Full Gumbel search (config.gumbel_m > 0): one Gumbel sample per
        game and action, -log(-log(U)) with U from `gen`, drives sequential
        halving at the root over `num_waves` waves.  `mesh` as in
        `add_noise`.  Returns (tree, gumbel [B, A])."""
        if self.config.gumbel_m <= 0:
            raise ValueError("set SearchConfig.gumbel_m > 0 for gumbel search")
        u = _row_draw(
            lambda shape: torch.rand(shape, generator=gen,
                                     device=tree.root_prior.device),
            tree.root_prior.shape, mesh)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return self._run_sims_gumbel(params, tree, gumbel), gumbel

    @torch.no_grad()
    def _run_sims_gumbel(self, params, tree: Tree, gumbel) -> Tree:
        """`run_sims_gumbel` with the Gumbel sample given [B, A]."""
        with span("search"):
            for w in range(self.config.num_waves):
                self._wave(self._wave_xla, params, tree, gumbel, w)
        return tree

    def select_moves_gumbel(self, tree: Tree, gumbel) -> torch.Tensor:
        """Deterministic Gumbel move: argmax over visited root actions of
        g + log pi + sigma(completed q) (ties -> last).  int32 [B]."""
        scores = self._gumbel_scores(tree, gumbel)
        visited = tree.root_n > 0
        sel = torch.where(visited, scores,
                          torch.full_like(scores, float("-inf")))
        use = torch.where(visited.any(-1, keepdim=True), sel, scores)
        return _last_argmax(use).to(torch.int32)

    def gumbel_policy_weights(self, tree: Tree) -> torch.Tensor:
        """Improved policy for training targets [B, A]: softmax over legal
        actions of log pi + sigma(completed q), as `jax.nn.softmax`
        computes it (exp(x - max) / sum)."""
        x = self._gumbel_scores(tree, torch.zeros_like(tree.root_w))
        e = torch.exp(x - x.max(-1, keepdim=True).values)
        return e / e.sum(-1, keepdim=True)

    @torch.no_grad()
    def run_sims(self, params, tree: Tree) -> Tree:
        """Full search: `num_waves` waves, in ceil(num_waves / chunk)
        chunks of `chunk` = ceil(scan_chunk / wave_size) waves each when
        `scan_chunk` is set, so that the search runs whole chunks and may
        run more than `num_waves` waves (`tak_tpu` search.py:947-954,
        996-1014).  On the pool tier a chunk's waves are pipelined (it
        starts with nothing pending and ends with the expand+backup flush,
        as `tak_tpu` search.py:956-994); on the large-tree tier every wave
        is whole in itself."""
        cfg = self.config
        total = cfg.num_waves
        chunk = total
        if cfg.scan_chunk:
            chunk = min(total, -(-cfg.scan_chunk // cfg.wave_size))
        chunks = -(-total // chunk)
        with span("search"):
            if self.tier in ("xla", "hbm"):
                wave = (self._wave_xla if self.tier == "xla"
                        else self._wave_hbm)
                for _ in range(chunks * chunk):
                    self._wave(wave, params, tree)
                return tree
            B = tree.n0.shape[0]
            for _ in range(chunks):
                pending = Pending.zeros(B, cfg.wave_size, cfg.max_children,
                                        tree.n0.device)
                for _ in range(chunk):
                    pending = self._wave(self._wave_pipelined, params, tree,
                                         pending)
                with span("search.flush"):
                    expand_backup_wave(tree, pending,
                                       recycle=self._kernel_args()["recycle"])
        return tree

    def select_moves(self, gen, tree: Tree, exploit,
                     mesh=None) -> torch.Tensor:
        """Per game: argmax visits (ties -> last) where `exploit`, else a
        sample proportional to visits (play.rs:49-67).  int32 [B].  With
        `mesh` the tree holds this rank's games, `exploit` covers the whole
        batch, and the choice is made on every rank's gathered root visits
        (the draws and the all-exploit test are those of one process
        holding every game), then cut to this rank's rows."""
        visits = gather_rows(mesh, root_visit_counts(tree))
        greedy = _last_argmax(visits)
        exploit = exploit.to(visits.device)
        with span("search.exploit_all", sync=True):
            all_exploit = bool(exploit.all())
        if all_exploit:
            return shard_rows(mesh, greedy.to(torch.int32))
        probs = visits.float()
        empty = probs.sum(-1, keepdim=True) <= 0
        legal = gather_rows(mesh, tree.root_legal)
        probs = torch.where(empty, legal.float() + 1e-30, probs)
        sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return shard_rows(mesh, torch.where(exploit, greedy,
                                            sampled).to(torch.int32))
