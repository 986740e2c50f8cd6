"""The program's side of every driver: the network built from a
configuration file, the benchmark's spans around the calls into the
program, and what those spans capture for the comparison.

Only this file and the drivers import `tak_tpu_torch`; nothing here
changes what the program computes.  The wrappers time and count the
calls and keep a seeded reservoir sample of the window's calls: of the
evaluations, their input rows and outputs (the value head's output before
its tanh among them); of the pool tier's tree kernels, the tree before
and after a launch, the wave it backed up and the leaves it chose.  In a
traced run each launch so drawn while the profiler runs is timed alone,
for the kernels' roofline share.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import counts, net, weights
from benchmark.reference import tree as ref_tree

# the evaluation calls kept for the comparison, and their rows a call
EVAL_CALLS = 16
ROWS_PER_CALL = 64
# the tree kernel launches kept, and their games a launch
TREE_LAUNCHES = 8
TREE_GAMES = 8


def flax_weights(ctx) -> dict:
    """`{params, batch_stats}` of the configuration: its weights file
    (sha256 checked), or, where it names none, random weights made from
    the seed by the benchmark (`net.random_flax`)."""
    c = ctx.config
    if c.get("weights"):
        return weights.load_flax(ctx.path(c["weights"]), c["weights_sha256"])
    return net.random_flax(c["board_size"], c["filters"], c["blocks"],
                           ctx.seed)


def network(ctx, tree: dict):
    """(engine, Network, variables) of the configuration, the variables
    read by the program from the same file (or the same random tree)."""
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import Network, variables_from_numpy
    from tak_tpu_torch.model.resnet import NetConfig

    c = ctx.config
    engine = get_engine(c["board_size"])
    cfg = NetConfig(n=c["board_size"], filters=c["filters"],
                    blocks=c["blocks"], policy_head=c["policy_head"],
                    dtype=getattr(torch, c["compute_dtype"]))
    nw = Network(engine, cfg, device=ctx.device)
    if c.get("weights"):
        variables = nw.load(str(ctx.path(c["weights"])))
    else:
        variables = variables_from_numpy(tree["params"], tree["batch_stats"],
                                         cfg)
    variables = {k: v.to(ctx.device) for k, v in variables.items()}
    return engine, nw, variables


class Reservoir:
    """A seeded uniform sample of `size` of the window's calls (Algorithm
    R).  Each call is drawn before it runs, so that only the calls kept
    are copied: `draw()` gives the slot a call goes to, or None."""

    def __init__(self, seed: int, salt: int, size: int):
        self.rng = np.random.default_rng([seed, salt])
        self.size = size
        self.seen = 0
        self.items = []

    def draw(self):
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.items.append(None)
            return i
        j = int(self.rng.integers(i + 1))
        return j if j < self.size else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item

    @property
    def kept(self) -> list:
        return [x for x in self.items if x is not None]


class EvalTap:
    """The evaluation callable handed to the search: a span around the
    network's `policy_eval_states`, the rows counted, and in the window a
    reservoir of calls whose (states, policy, value, value before tanh)
    rows are kept on the device.  The value head's output is read by a
    forward hook on the network's value layer."""

    def __init__(self, ctx, nw):
        self.ctx = ctx
        self.nw = nw
        self.calls = Reservoir(ctx.seed, 1, EVAL_CALLS)
        self._logit = None
        nw.model.value.register_forward_hook(self._keep_logit)

    def _keep_logit(self, module, inputs, output):
        self._logit = output

    def __call__(self, params, states):
        ctx = self.ctx
        self._logit = None
        with ctx.rec.span("eval"):
            pol, val = self.nw.policy_eval_states(params, states)
        rows = int(states.ply.shape[0])
        ctx.window.count("rows", rows)
        if ctx.window.open:
            slot = self.calls.draw()
            if slot is not None:
                idx = np.sort(self.calls.rng.choice(
                    rows, min(ROWS_PER_CALL, rows), replace=False))
                i = torch.as_tensor(idx, device=pol.device)
                lg = self._logit
                lg = (lg[:, 0][i].float() if lg is not None
                      and lg.shape[0] == rows
                      else torch.full((len(idx),), float("nan"),
                                      device=pol.device))
                self.calls.put(slot, (states[i], pol[i], val[i], lg))
        return pol, val

    def host_samples(self):
        """(fields of the sampled states, policy [R, A], value [R], value
        before tanh [R]) on the host."""
        kept = self.calls.kept
        if not kept:
            return None, None, None, None
        fields = {}
        for st, _, _, _ in kept:
            for k, v in st.to_numpy().items():
                fields.setdefault(k, []).append(v)
        fields = {k: np.concatenate(v) for k, v in fields.items()}
        pol, val, lg = (torch.cat([x[j].float().cpu() for x in kept])
                        for j in (1, 2, 3))
        return fields, pol, val, lg


class KernelTap:
    """The pool tier's tree kernels wrapped where the search module calls
    them.  A reservoir of the window's launches keeps, for TREE_GAMES
    games drawn from the seed, the tree's fields before and after the
    launch, the wave it backed up and the leaves it chose, for the plain
    reference (`reference/tree.py`).  In a traced run a launch so drawn
    while the profiler runs is run inside a `tree_sample` span and its
    least time (the frozen byte and operation counts) is kept."""

    NAMES = ("backup_descend_wave", "expand_backup_wave")

    def __init__(self, ctx, recycle: bool):
        self.ctx = ctx
        self.recycle = recycle
        self.launches = Reservoir(ctx.seed, 3, TREE_LAUNCHES)
        self.least = []
        self.saved = {}

    @contextlib.contextmanager
    def installed(self):
        from tak_tpu_torch.mcts import search

        for name in self.NAMES:
            self.saved[name] = getattr(search, name)
            setattr(search, name, self._wrap(name, self.saved[name]))
        try:
            yield
        finally:
            for name, fn in self.saved.items():
                setattr(search, name, fn)

    def _wrap(self, name, fn):
        def tapped(tree, pending, **kw):
            ctx = self.ctx
            slot = self.launches.draw() if ctx.window.open else None
            if slot is None:
                return fn(tree, pending, **kw)
            B = tree.n0.shape[0]
            games = torch.as_tensor(np.sort(self.launches.rng.choice(
                B, min(TREE_GAMES, B), replace=False)), device=tree.n0.device)
            before = {f: getattr(tree, f).clone() for f in ref_tree.FIELDS}
            wave = {f: getattr(pending, f)[games] for f in ref_tree.PENDING}
            timed = ctx.window.tracing
            with (ctx.rec.span("tree_sample") if timed
                  else contextlib.nullcontext()):
                out = fn(tree, pending, **kw)
            after = {f: getattr(tree, f).clone() for f in ref_tree.FIELDS}
            if timed:
                self.least.append(self._least(name, pending, before, after))
            chosen = None if out is None else {
                "leaves": out[0][games], "created": out[1][games]}
            self.launches.put(slot, (
                {f: x[games] for f, x in before.items()},
                {f: x[games] for f, x in after.items()},
                wave, bool(pending.valid), chosen))
            return out
        return tapped

    def _least(self, name, pending, before, after) -> float:
        B, M, K = before["edge_n"].shape
        A = before["root_n"].shape[1]
        V = pending.leaves.shape[1]
        descend = name == "backup_descend_wave"
        backup = bool(pending.valid) or not descend
        nbytes = counts.tree_bytes(before, after, V, descend, backup)
        ops = counts.tree_ops(B, V, A, M, descend, self.recycle)
        return counts.bound(nbytes, ops)[0]

    def host_samples(self) -> list:
        """Per kept launch and game: (before, after, wave, valid, chosen)
        as numpy arrays of that game."""
        def host(d):
            return None if d is None else {k: v.cpu().numpy()
                                           for k, v in d.items()}

        out = []
        for before, after, wave, valid, chosen in self.launches.kept:
            before, after, wave, chosen = map(host, (before, after, wave,
                                                     chosen))
            for g in range(len(before["n0"])):
                def pick(d):
                    return None if d is None else {k: v[g]
                                                   for k, v in d.items()}
                out.append((pick(before), pick(after), pick(wave), valid,
                            pick(chosen)))
        return out


def search_counts(tree):
    """Per game (root visits summed, n0) of a tree, on the device."""
    return tree.root_n.sum(-1), tree.n0.clone()


def search_leftovers(tree):
    """Per game, the virtual visits left at the root after a search."""
    return tree.root_virt.sum(-1) + tree.virt0
