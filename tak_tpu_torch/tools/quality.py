"""What the root-policy quality probes share (`quality_recycle`,
`quality_control`, `quality_k`): random midgame positions, the searched
root policies of a batch of positions, and their total-variation
distance and top-1 agreement.

The positions are the reference's seeded legal playouts
(`tools/quality_recycle.py:63-75`) drawn from a `torch.Generator` seeded
42 instead of `jax.random.PRNGKey(42)`, whose bits cannot be reproduced:
the port's positions, and so its TV numbers, are its own.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..engine.core import get_engine
from ..mcts.search import MCTS, SearchConfig
from ..mcts.tree import root_visit_counts
from ..model.network import Network
from ..types import ONGOING
from ..utils.device import resolve_device, setup_performance_defaults

POSITIONS_SEED = 42
HALF_KOMI = 4


def random_midgame_states(engine, games: int, plies: int, gen, device):
    """`games` fresh games (half komi 4) after `plies` uniform random legal
    moves, finished games frozen.  Each ply draws one 16-bit word per
    (game, action) from `gen` on its own device and plays the legal action
    with the largest word (the first on ties); the positions are moved to
    `device` so that a CPU generator gives the same positions anywhere."""
    dev = resolve_device(device)
    states = engine.initial_batch(games, HALF_KOMI, dev)
    for _ in range(plies):
        legal = engine.legal_mask(states)
        # words from 1, so that a legal action always beats the zeros of
        # the illegal ones
        bits = torch.randint(1, 1 << 16, legal.shape, generator=gen,
                             device=gen.device, dtype=torch.int32).to(dev)
        acts = torch.where(legal, bits, 0).argmax(-1).to(torch.int32)
        states = engine.step(states, acts, states.result == ONGOING)
    return states


def search(engine, eval_fn, variables, states, sims: int, wave: int, *,
           k: int, budget=None, recycle: bool = False, backend: str = "auto",
           chunk=None, topk: str = "exact"):
    """One search of `sims` rollouts from each of `states` (fresh trees):
    (the `MCTS`, its searched tree)."""
    cfg = SearchConfig(num_sims=sims, wave_size=wave, max_children=k,
                       node_budget=budget, recycle=recycle, backend=backend,
                       scan_chunk=chunk, topk_impl=topk)
    mcts = MCTS(engine, eval_fn, cfg)
    tree = mcts.prepare_root(variables, mcts.init_batch(states))
    return mcts, mcts.run_sims(variables, tree)


def normalized_visits(tree) -> np.ndarray:
    """The root visit distribution [B, A] in float64 on the host (all zero
    where a root has no visited child)."""
    v = root_visit_counts(tree).cpu().numpy().astype(np.float64)
    return v / np.maximum(v.sum(-1, keepdims=True), 1.0)


def root_policies(engine, net, variables, states, sims: int, wave: int, *,
                  k: int, budget=None, recycle: bool = False,
                  backend: str = "auto", chunk=None, topk: str = "exact"):
    """Normalized root visits [B, A] (float64, host) of one search from
    each of `states` with `net.policy_eval_states`
    (`tools/quality_recycle.py:33-48` and `tools/quality_k.py:25-38`)."""
    _, tree = search(engine, net.policy_eval_states, variables, states,
                     sims, wave, k=k, budget=budget, recycle=recycle,
                     backend=backend, chunk=chunk, topk=topk)
    return normalized_visits(tree)


def tv_top1(p: np.ndarray, q: np.ndarray):
    """(mean TV distance, max TV distance, top-1 agreement) over the rows."""
    tv = 0.5 * np.abs(p - q).sum(-1)
    return float(tv.mean()), float(tv.max()), float(
        np.mean(p.argmax(-1) == q.argmax(-1)))


def print_tv(p: np.ndarray, q: np.ndarray) -> None:
    """The probes' two result lines."""
    tv_mean, tv_max, top1 = tv_top1(p, q)
    print(f"  TV distance: mean {tv_mean:.4f}  max {tv_max:.4f}")
    print(f"  top-1 agreement: {top1:.3f}")


def add_position_flags(ap: argparse.ArgumentParser, sims: int, wave: int,
                       games: int) -> None:
    """The flags every probe has, with its defaults."""
    ap.add_argument("--sims", type=int, default=sims)
    ap.add_argument("--wave", type=int, default=wave)
    ap.add_argument("--games", type=int, default=games)
    ap.add_argument("--plies", type=int, default=24,
                    help="random midgame depth")
    ap.add_argument("--size", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")


def probe_setup(args):
    """(engine, network, variables, positions) of a probe: the default
    network of the size on seed-0 weights, `args.games` positions
    `args.plies` random plies deep, on the card unless `args.cpu`."""
    device = resolve_device("cpu" if args.cpu else "cuda")
    setup_performance_defaults(device)
    engine = get_engine(args.size)
    net = Network(engine, device=device)
    variables = net.init_variables(0)
    gen = torch.Generator().manual_seed(POSITIONS_SEED)
    states = random_midgame_states(engine, args.games, args.plies, gen,
                                   device)
    return engine, net, variables, states
