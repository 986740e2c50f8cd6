"""Tree-in-tensors storage for batched MCTS (counterpart of `tak_tpu/mcts/tree.py`).

All B concurrent searches live in fixed-shape tensors with a leading
game axis.  Statistics are edge-resident: visits, virtual visits and
reward sums live on the parent's edge slot, and on dense per-action
arrays at the root.

  * node tier [B, M]: the full `GameState`, cached result, parent /
    parent_slot / parent_action links, `expanded` flag, and the
    recycling bookkeeping node_n / node_virt / child_count.
  * edge tier [B, M, K]: action id, prior, child pointer, visits,
    virtual visits, reward sum (parent-mover perspective).
  * root tier [B, A]: full-width prior / legal / child / visits /
    virtual / reward arrays over the whole action space.

The fields stay unpacked: the JAX kernels' `pm`/`epac` packing existed to
save TPU VMEM and buys nothing in device memory.  The tree kernels
(`mcts/tree_kernels.py`) update these tensors in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..types import GameState

NONE = -1  # null node / unused edge slot

NODE_FIELDS = ("result", "parent", "parent_slot", "parent_action", "expanded",
               "node_n", "node_virt", "child_count")
EDGE_FIELDS = ("edge_action", "edge_prior", "edge_child", "edge_n",
               "edge_virt", "edge_w")
ROOT_FIELDS = ("root_prior", "root_child", "root_legal", "root_n",
               "root_virt", "root_w")
SCALAR_FIELDS = ("n0", "virt0", "next_free")
TENSOR_FIELDS = NODE_FIELDS + EDGE_FIELDS + ROOT_FIELDS + SCALAR_FIELDS


@dataclass
class Tree:
    state: GameState                # leading [B, M] on every field
    result: torch.Tensor            # int32 [B, M]
    parent: torch.Tensor            # int32 [B, M] (NONE for the root)
    parent_slot: torch.Tensor       # int32 [B, M] (NONE = root edge)
    parent_action: torch.Tensor     # int32 [B, M]
    expanded: torch.Tensor          # bool  [B, M]
    node_n: torch.Tensor            # int32 [B, M] eviction score
    node_virt: torch.Tensor         # int32 [B, M] in-flight pins
    child_count: torch.Tensor       # int32 [B, M] materialized children
    edge_action: torch.Tensor       # int32 [B, M, K]
    edge_prior: torch.Tensor        # f32   [B, M, K]
    edge_child: torch.Tensor        # int32 [B, M, K]
    edge_n: torch.Tensor            # int32 [B, M, K]
    edge_virt: torch.Tensor         # int32 [B, M, K]
    edge_w: torch.Tensor            # f32   [B, M, K]
    root_prior: torch.Tensor        # f32   [B, A]
    root_child: torch.Tensor        # int32 [B, A]
    root_legal: torch.Tensor        # bool  [B, A]
    root_n: torch.Tensor            # int32 [B, A]
    root_virt: torch.Tensor         # int32 [B, A]
    root_w: torch.Tensor            # f32   [B, A]
    n0: torch.Tensor                # int32 [B] root visits
    virt0: torch.Tensor             # int32 [B] root virtual visits
    next_free: torch.Tensor         # int32 [B] next unallocated node

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "Tree":
        return Tree(state=self.state.clone(),
                    **{f: getattr(self, f).clone() for f in TENSOR_FIELDS})

    def to_numpy(self) -> dict:
        out = {f: getattr(self, f).cpu().numpy() for f in TENSOR_FIELDS}
        out["state"] = self.state.to_numpy()
        return out

    @staticmethod
    def from_numpy(fields, device="cpu") -> "Tree":
        """From a mapping (or object with attributes) of numpy-like arrays
        in the JAX package's `Tree` layout."""
        import numpy as np

        get = (fields.__getitem__ if isinstance(fields, dict)
               else lambda f: getattr(fields, f))
        vals = {}
        for f in TENSOR_FIELDS:
            a = np.array(get(f))
            if a.dtype == np.bool_:
                vals[f] = torch.as_tensor(a, device=device)
            elif a.dtype.kind == "f":
                vals[f] = torch.as_tensor(a.astype(np.float32), device=device)
            else:
                vals[f] = torch.as_tensor(a.astype(np.int32), device=device)
        return Tree(state=GameState.from_numpy(get("state"), device), **vals)


def init_tree(engine, root_states: GameState, max_nodes: int, k: int) -> Tree:
    """Fresh trees for a batch of root states (node 0, unexpanded)."""
    M, K, A = max_nodes, k, engine.num_actions
    B = root_states.ply.shape[0]
    dev = root_states.device

    def node_tier(x):
        out = torch.zeros((B, M) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[:, 0] = x
        return out

    def full(shape, v, dtype=torch.int32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    state = root_states.map(node_tier)
    return Tree(
        state=state,
        result=state.result.clone(),
        parent=full((B, M), NONE),
        parent_slot=full((B, M), NONE),
        parent_action=full((B, M), NONE),
        expanded=full((B, M), False, torch.bool),
        node_n=full((B, M), 0),
        node_virt=full((B, M), 0),
        child_count=full((B, M), 0),
        edge_action=full((B, M, K), NONE),
        edge_prior=full((B, M, K), 0.0, torch.float32),
        edge_child=full((B, M, K), NONE),
        edge_n=full((B, M, K), 0),
        edge_virt=full((B, M, K), 0),
        edge_w=full((B, M, K), 0.0, torch.float32),
        root_prior=full((B, A), 0.0, torch.float32),
        root_child=full((B, A), NONE),
        root_legal=full((B, A), False, torch.bool),
        root_n=full((B, A), 0),
        root_virt=full((B, A), 0),
        root_w=full((B, A), 0.0, torch.float32),
        n0=full((B,), 0),
        virt0=full((B,), 0),
        next_free=full((B,), 1),
    )


def root_visit_counts(tree: Tree) -> torch.Tensor:
    """Visit count per root action [B, A], the improved policy."""
    return torch.where(tree.root_legal, tree.root_n,
                       torch.zeros_like(tree.root_n))
