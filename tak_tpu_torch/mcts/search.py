"""Batched MCTS with PUCT, virtual loss and wave evaluation.

Counterpart of `tak_tpu/mcts/search.py` on its two fused-kernel paths,
named as there (`SearchConfig.backend`):

  * "pallas", the pool tier (`tree_kernels.py`): every wave runs one
    merged backup+descend kernel, the fused leaf step, `observe` and the
    network, and the masked top-K; each chunk of waves ends with an
    expand+backup flush.  Supports node recycling.
  * "pallas_hbm", the large-tree tier (`tree_kernels_hbm.py`, pools up to
    140,000 nodes, no recycling; the single-game `Player`): every wave is
    descend -> step/evaluate/top-K -> expand+backup, not pipelined.

"auto" follows the reference's rule (search.py:254-259): the pool tier
when the tree passes `fits_in_vmem`, else the large-tree tier when not
recycling and the pool is within `MAX_HBM_NODES`.  Search semantics
follow `alpha-tak/src/search/mcts.rs` as the JAX package does:
C(N) = ln((1+N+500)/500) + 4, virtual visits counted as losses, last-max
ties, terminal leaves backing up the anchored outcome.

Two options of the reference change how a wave's leaves get their legal
moves and top-K priors, on both tiers:

  * `fused_leaf_legal`: the leaf step is the fused step that also emits
    the packed legal bits (`engine/legal_bits.py` `step_legal`), and the
    top-K reads the words (`masked_topk_packed`) instead of a dense legal
    mask.  The trees are identical either way.  The reference takes this
    path only when B*V is a multiple of 128, a TPU lane rule; the port's
    kernel has no such rule and applies at any row count.
  * `topk_impl`: "exact", or the one-int32-key "packed" / "packedq" top-K
    (`masked_topk`).

Not ported yet (ROADMAP.md): the XLA staggered-descent path
(`backend="xla"`) and Gumbel root selection.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..engine.legal_bits import masked_topk_packed
from ..types import GameState
from .tree import Tree, init_tree, root_visit_counts
from .tree_kernels import (
    Pending,
    _last_argmax,
    backup_descend_wave,
    expand_backup_wave,
    fits_in_vmem,
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
    # tree kernels: "auto" | "pallas" (pool tier) | "pallas_hbm" (large-tree
    # tier); the reference's names, see the module docstring
    backend: str = "auto"
    # top-K child selection: "exact" | "packed" | "packedq" (see
    # masked_topk).  The reference's "auto" is packedq on the TPU and exact
    # on the CPU; the port's "auto" is "exact" on both devices: its default
    # trees stay bitwise those of the exact top-K until a measurement on
    # the card (PERF.md) argues for a change.
    topk_impl: str = "auto"
    # take the leaves' legal moves from the fused step as packed words and
    # run the top-K on the words, instead of a dense legal mask per wave
    fused_leaf_legal: bool = False
    # node recycling: a create in a full pool evicts the coldest unpinned
    # childless node instead of degrading to a parent re-eval
    recycle: bool = False
    # reroot-time carry compaction: keep at most this many carried nodes
    reroot_keep: int | None = None
    # run the waves in chunks of ~this many sims (rounded up to whole
    # waves), each ending with the expand+backup flush
    scan_chunk: int | None = None

    @property
    def num_waves(self) -> int:
        return -(-self.num_sims // self.wave_size)

    @property
    def max_nodes(self) -> int:
        return self.node_budget or (self.num_waves * self.wave_size + 2)


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
    package's function of the same name."""
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

    def _resolve_tier(self) -> str:
        """"pool" or "hbm": which pair of tree kernels the waves run."""
        cfg = self.config
        if cfg.backend == "xla":
            raise NotImplementedError(
                "the XLA staggered-descent path is not ported (ROADMAP.md)")
        if cfg.backend not in ("auto", "pallas", "pallas_hbm"):
            raise ValueError(f"unknown search backend {cfg.backend!r}")
        if cfg.recycle and cfg.backend == "pallas_hbm":
            raise ValueError(
                "node recycling runs on the pool tier only; the large-tree "
                "tier does not support it")
        if cfg.backend == "pallas":
            return "pool"
        if cfg.backend == "pallas_hbm":
            return "hbm"
        if fits_in_vmem(cfg.max_nodes, cfg.max_children,
                        self.engine.num_actions):
            return "pool"
        if not cfg.recycle and fits_hbm(cfg.max_nodes):
            return "hbm"
        raise NotImplementedError(
            f"a {cfg.max_nodes}-node tree with recycle={cfg.recycle} fits "
            "neither tree-kernel tier; the reference falls back to its XLA "
            "path, which is not ported (ROADMAP.md)")

    def init_batch(self, root_states: GameState) -> Tree:
        return init_tree(self.engine, root_states, self.config.max_nodes,
                         self.config.max_children)

    @torch.no_grad()
    def prepare_root(self, params, tree: Tree) -> Tree:
        """Expand unexpanded roots with one evaluation (rollout #1)."""
        need = ~tree.expanded[:, 0]
        if not bool(need.any()):
            return tree
        root_states = tree.state[:, 0]
        policy, _ = self.eval_fn(params, root_states)
        legal = self.engine.legal_mask(root_states)
        m = need[:, None]
        tree.root_prior.copy_(torch.where(m, policy.float(), tree.root_prior))
        tree.root_legal.copy_(torch.where(m, legal, tree.root_legal))
        tree.n0 += need.int()
        tree.expanded[:, 0] |= need
        return tree

    def add_noise(self, gen, tree: Tree, alpha: float, ratio: float,
                  apply_mask) -> Tree:
        """Dirichlet root noise: p <- ratio*noise + (1-ratio)*p."""
        gammas = _gamma_fixed(gen, alpha, tuple(tree.root_prior.shape),
                              tree.root_prior.device)
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

    def _leaf_states_of(self, tree: Tree, leaves):
        """Every leaf's state with one fused step: step(state[parent],
        parent_action).  Returns (flat states [B*V], the leaves' packed
        legal words (place, spread) with `fused_leaf_legal`, else None)."""
        inputs = self._leaf_step_inputs(tree, leaves)
        if self.config.fused_leaf_legal:
            flat, place, spread = self.engine.step_legal(*inputs)
            return flat, (place, spread)
        return self.engine.step(*inputs), None

    def _write_nodes(self, tree: Tree, leaves, created, flat_states: GameState,
                     leaf_results) -> None:
        """Write created nodes' states and results (unique indices)."""
        B, V = leaves.shape
        g, v = torch.nonzero(created, as_tuple=True)
        idx = leaves[g, v].long()
        for f in ("stacks", "heights", "tops", "to_move", "ply", "stones",
                  "caps", "half_komi", "reversible", "result"):
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
        policy, value = self.eval_fn(params, flat)
        leaf_results = flat.result.reshape(B, V)
        if fused_legal is not None:
            vals, aidx = masked_topk_packed(self.engine, policy, *fused_legal,
                                            K)
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

    def _kernel_args(self):
        cfg = self.config
        return dict(base=float(cfg.exploration_base),
                    init=float(cfg.exploration_init), recycle=bool(cfg.recycle))

    def _wave_pipelined(self, params, tree: Tree, pending: Pending) -> Pending:
        """Apply the previous wave's expansions and backups fused with this
        wave's descents (one merged kernel), then step/evaluate the new
        leaves.  Callers flush the final pending with the expand+backup."""
        leaves, created = backup_descend_wave(tree, pending,
                                              **self._kernel_args())
        return self._eval_and_topk(params, tree, leaves, created)

    def _wave_hbm(self, params, tree: Tree) -> None:
        """One large-tier wave: descend -> step/evaluate/top-K ->
        expand+backup (`tak_tpu` search.py:860-876)."""
        cfg = self.config
        leaves, created = descend_wave_hbm(
            tree, cfg.wave_size, base=float(cfg.exploration_base),
            init=float(cfg.exploration_init))
        expand_backup_wave_hbm(
            tree, self._eval_and_topk(params, tree, leaves, created))

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
        if self.tier == "hbm":
            for _ in range(chunks * chunk):
                self._wave_hbm(params, tree)
            return tree
        B = tree.n0.shape[0]
        for _ in range(chunks):
            pending = Pending.zeros(B, cfg.wave_size, cfg.max_children,
                                    tree.n0.device)
            for _ in range(chunk):
                pending = self._wave_pipelined(params, tree, pending)
            expand_backup_wave(tree, pending,
                               recycle=self._kernel_args()["recycle"])
        return tree

    def select_moves(self, gen, tree: Tree, exploit) -> torch.Tensor:
        """Per game: argmax visits (ties -> last) where `exploit`, else a
        sample proportional to visits (play.rs:49-67).  int32 [B]."""
        visits = root_visit_counts(tree)
        greedy = _last_argmax(visits)
        exploit = exploit.to(visits.device)
        if bool(exploit.all()):
            return greedy.to(torch.int32)
        probs = visits.float()
        empty = probs.sum(-1, keepdim=True) <= 0
        probs = torch.where(empty, tree.root_legal.float() + 1e-30, probs)
        sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return torch.where(exploit, greedy, sampled).to(torch.int32)
