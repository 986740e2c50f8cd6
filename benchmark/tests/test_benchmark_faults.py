"""The comparison fails a broken program: each driver's run at a tiny
size with the timed path broken underneath (a search that returns its
tree unchanged, a network that evaluates half of the batch and hands the
rest the mean of what it computed, a step or an answer altered where it
is produced, a value head's output shifted, a tree kernel's backup
negated, its exploration term negated or a new row's priors reversed, a
training call that returns its variables unchanged or leaves half of
each chunk out) comes out not correct.  The cells run on
one card, so no exchange between cards can be left out.

And the control: the plain reference in float8 e4m3 in the program's
place, at the configurations' widths and trained weights on positions of
random games, reads above every limit of the cells."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO
from test_benchmark_tree import (flipped_backup, negated_exploration,
                                 reversed_priors)

SEED = 2 ** 31 + 5


def run(layout, manifest, cell):
    from benchmark import run as bench_run

    result, _ = bench_run.run_cell(layout, manifest, cell, SEED, 1.0, False,
                                   torch.device("cpu"),
                                   t_start=time.perf_counter())
    return result


def unchanged_search(monkeypatch):
    from tak_tpu_torch.mcts.search import MCTS

    monkeypatch.setattr(MCTS, "run_sims", lambda self, params, tree: tree)


def half_batch_eval(monkeypatch):
    from tak_tpu_torch.model.network import Network

    real = Network.policy_eval_states

    def half(self, variables, states):
        R = states.ply.shape[0]
        keep = max(1, R // 2)
        pol, val = real(self, variables, states[torch.arange(keep)])
        return (torch.cat([pol, pol.mean(0, keepdim=True).expand(
                    R - keep, -1)]),
                torch.cat([val, val.mean().expand(R - keep)]))

    monkeypatch.setattr(Network, "policy_eval_states", half)


def altered_step(monkeypatch):
    from tak_tpu_torch.engine.core import Engine

    real = Engine.step

    def step(self, state, action, enabled=None):
        out = real(self, state, action, enabled)
        if state.ply.shape[0] <= 64:      # the moves played, not the leaves
            out = out.replace(reversible=out.reversible + 1)
        return out

    monkeypatch.setattr(Engine, "step", step)


def altered_value(monkeypatch):
    from tak_tpu_torch.model.network import Network

    real = Network.policy_eval_states

    def flipped(self, variables, states):
        pol, val = real(self, variables, states)
        return pol, -val

    monkeypatch.setattr(Network, "policy_eval_states", flipped)


def unchanged_training(monkeypatch):
    from tak_tpu_torch.model.network import Network

    monkeypatch.setattr(Network, "train",
                        lambda self, variables, examples, **kw: variables)


def half_chunk_training(monkeypatch):
    from tak_tpu_torch.model.network import Network

    real = Network._accum_chunk

    def half(self, model, states, acts, vis, z, world=1):
        keep = torch.arange(max(1, z.shape[0] // 2))
        return real(self, model, states[keep], acts[keep], vis[keep],
                    z[keep], world)

    monkeypatch.setattr(Network, "_accum_chunk", half)


def altered_value_head(monkeypatch):
    from tak_tpu_torch.model.resnet import Linear

    real = Linear.forward

    def shifted(self, x):
        out = real(self, x)
        return out + 0.5 if self.out_features == 1 else out

    monkeypatch.setattr(Linear, "forward", shifted)


FAULTS = [
    ("tiny.selfplay", unchanged_search),
    ("tiny.selfplay", half_batch_eval),
    ("tiny.selfplay", altered_step),
    ("tiny.selfplay", flipped_backup),
    ("tiny.selfplay", negated_exploration),
    ("tiny.selfplay", reversed_priors),
    ("tiny.selfplay.fresh", altered_value),
    ("tiny.selfplay.fresh", altered_value_head),
    ("tiny.selfplay.fresh", unchanged_search),
    ("tiny.selfplay.fresh", flipped_backup),
    ("tiny.learner", unchanged_training),
    ("tiny.learner", half_chunk_training),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    layout, manifest = tiny
    fault(monkeypatch)
    try:
        result = run(layout, manifest, cell)
    except (RuntimeError, ValueError, IndexError):
        return      # the run ends without a result line: not correct either
    assert result["correct"] is False, result["checks"]


def random_positions(n, count, plies, seed):
    from benchmark.reference import tak

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        pos = tak.Position(n, [[] for _ in range(n * n)], [0] * (n * n), 0, 0,
                           list(tak.START[n][:1]) * 2,
                           [tak.START[n][1]] * 2, 4, 0, 0)
        for _ in range(int(rng.integers(2, plies))):
            legal = sorted(pos.legal_actions())
            if not legal:
                break
            pos = pos.step(int(legal[rng.integers(len(legal))]))
        rows.append(pos.fields())
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


SEARCH_CELLS = ["net6.selfplay.ref"]


@pytest.mark.parametrize("cell", SEARCH_CELLS)
def test_network_control_fails(cell):
    from benchmark import checks
    from benchmark.reference import net, weights

    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {w["name"]: w["config"] for w in manifest["workloads"]}
    if cell not in names:
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    cfg = json.loads((BENCH / "configs" / f"{names[cell]}.json").read_text())
    limits = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())[
        "limits"]
    tree = weights.load_flax(REPO / cfg["weights"], cfg["weights_sha256"])
    w = net.to_torch(net.leaves(tree, cfg["blocks"]), "cpu")
    fields = random_positions(cfg["board_size"], 48, 40, 3)
    got = checks.network(fields, None, None, None, w, cfg["board_size"],
                         "cpu", quant="fp8")
    assert any(got[k] > v for k, v in limits.items()), got
