"""Learner cells: the port's `Network.train` at the reference step, calls
back to back, each on 10,000 examples (20 chunks of 500, expanded 8x by
symmetry to 80,000 rows, one Adam step), the variables of one call handed
to the next.

Set-up: the network and its weights, the example pool made from the seed
(`inputs.learner_pool`), then `setup_calls` calls through the window's
own call on rows that all differ; the reference follows those calls.
The window opens when they end and closes at the end of the first call
that ends `seconds` after it; `learner_examples_per_s` is the examples of
the calls in between over that wall time, the prestack of each call
included.

Spans: `train` (`Network.train`).  Captured in set-up for the comparison:
each chunk's loss (`Network._loss`), the model and the Adam state of the
first call (`Network._train_model`, `Network.make_optimizer`), the
variables after each call.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.harness import Check, Outcome
from benchmark.reference import learner, net

NUMBERS = ("loss_gap", "grad_norm_gap", "grad_norm_gap_median",
           "change_norm_gap", "change_norm_gap_median")
# the port's parameter names -> the reference's leaves
_BN = {"weight": "bn_scale", "bias": "bn_bias"}


def leaf_name(name: str) -> str | None:
    parts = name.split(".")
    if parts[0] in ("policy", "value"):
        return f"{parts[0]}.{'kernel' if parts[1] == 'weight' else 'bias'}"
    if parts[0] == "stem":
        return f"conv0.{'kernel' if parts[1] == 'weight' else 'bias'}"
    if parts[0] == "stem_bn":
        return f"conv0.{_BN[parts[1]]}" if parts[1] in _BN else None
    if parts[0] == "blocks":
        i = 1 + 2 * int(parts[1]) + int(parts[2][-1])
        if parts[2].startswith("conv"):
            return f"conv{i}.{'kernel' if parts[3] == 'weight' else 'bias'}"
        return f"conv{i}.{_BN[parts[3]]}" if parts[3] in _BN else None
    return None


def leaf_gaps(prog: dict, ref: dict, raw_ref: dict) -> tuple:
    """(worst leaf's gap, median leaf's gap): over the leaves whose
    reference loss gradient is at least a thousandth of the median leaf's,
    the gap between the program's norm and the reference's, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    raw = {k: float(v.norm()) for k, v in raw_ref.items()}
    floor = 1e-3 * float(np.median(list(raw.values())))
    keys = [k for k in ref if raw[k] >= floor]
    norms = {k: float(ref[k].norm()) for k in keys}
    median = float(np.median(list(norms.values())))
    gaps = [abs(float(prog[k].norm()) - norms[k]) / max(norms[k], median)
            if k in prog else float("inf") for k in keys]
    return max(gaps), float(np.median(gaps))


def run(ctx) -> Outcome:
    wl, c = ctx.workload, ctx.config
    n = c["board_size"]
    tree = program.flax_weights(ctx)
    _, nw, variables = program.network(ctx, tree)
    per_call = wl["chunk_size"] * wl["chunks_in_step"]
    pool = inputs.learner_pool(n, wl["pool"], ctx.seed)
    from tak_tpu_torch.examples import Example

    fields = [k for k in pool if k not in ("actions", "visits", "z")]
    examples = []
    for i in range(wl["pool"]):
        k = int((pool["visits"][i] > 0).sum())
        examples.append(Example(
            state={f: pool[f][i] for f in fields},
            actions=pool["actions"][i, :k].copy(),
            visits=pool["visits"][i, :k].copy(),
            result=float(pool["z"][i])))
    calls = wl["pool"] // per_call
    rec, window = ctx.rec, ctx.window
    setup_calls = wl["setup_calls"]
    captured = {"losses": [], "model": None, "opt": None, "after": []}
    train_model, make_opt, loss_fn = (nw._train_model, nw.make_optimizer,
                                      nw._loss)

    def tapped_model(v, mesh=None):
        model = train_model(v, mesh)
        if captured["model"] is None:
            captured["model"] = model
        return model

    def tapped_opt(params):
        opt = make_opt(params)
        if captured["opt"] is None:
            captured["opt"] = opt
        return opt

    def tapped_loss(model, planes, pi, z, world=1):
        out = loss_fn(model, planes, pi, z, world)
        if len(captured["after"]) < setup_calls:
            captured["losses"].append(out[0].detach())
        return out

    nw._train_model = tapped_model
    nw.make_optimizer = tapped_opt
    nw._loss = tapped_loss
    start = {k: v.detach().clone() for k, v in variables.items()}
    current = variables
    done = 0
    examples_in = 0
    while True:
        i = done % calls
        part = examples[i * per_call:(i + 1) * per_call]
        with rec.span("train"):
            current = nw.train(current, part,
                               rng=np.random.default_rng([ctx.seed, done]),
                               log=lambda *a, **k: None,
                               chunk_size=wl["chunk_size"],
                               chunks_in_step=wl["chunks_in_step"])
        done += 1
        if done <= setup_calls:
            captured["after"].append({k: v.detach().clone()
                                      for k, v in current.items()})
            if done == setup_calls:
                window.start()
            continue
        examples_in += len(part)
        window.count("rows", 8 * len(part))
        if window.due():
            window.close()
            break
    extras = {"flops_per_row": c["forward_flops_per_row"]}
    model, opt = captured["model"], captured["opt"]
    first_grad = {}
    if opt is not None:        # None: no Adam step was taken
        beta1 = opt.param_groups[0]["betas"][0]
        for name, p in model.named_parameters():
            leaf = leaf_name(name)
            if leaf is not None and p in opt.state:
                first_grad[leaf] = (opt.state[p]["exp_avg"]
                                    / (1 - beta1)).cpu()
    prog_losses = torch.stack(captured["losses"] or [torch.zeros(())]
                              ).float().cpu().numpy()
    steps = len(prog_losses) // wl["chunks_in_step"]
    prog_step_loss = prog_losses[:steps * wl["chunks_in_step"]].reshape(
        steps, wl["chunks_in_step"]).mean(1)
    after = {leaf_name(k): v.cpu() for k, v in captured["after"][-1].items()
             if leaf_name(k) is not None}
    base = {leaf_name(k): v.cpu() for k, v in start.items()
            if leaf_name(k) is not None}
    holder = {"nw": nw, "captured": captured, "current": current,
              "examples": examples}

    def reference(quant=None, fault=None) -> dict:
        """The setup calls in the reference: each step's loss, the first
        step's gradient as Adam gets it, the change of every leaf, and the
        first step's loss gradient (which leaves count)."""
        w = net.to_torch(net.leaves(tree, c["blocks"]), ctx.device)
        w0 = {k: v.clone() for k, v in w.items()}
        losses, first, raw = [], None, None
        for call in range(setup_calls):
            off = (call % calls) * per_call
            order = off + np.random.default_rng([ctx.seed, call]).permutation(
                per_call)
            w, ls, grads = learner.train_call(
                w, pool, order, n, ctx.device, wl["chunk_size"],
                wl["chunks_in_step"], quant=quant, fault=fault)
            losses += ls
            if raw is None:
                raw = {k: v.cpu() for k, v in grads[0].items()}
                first = {k: (grads[0][k] + learner.WEIGHT_DECAY * w0[k]).cpu()
                         for k in raw}
        return {"losses": np.array(losses), "first": first, "raw": raw,
                "change": {k: (w[k] - w0[k]).cpu() for k in raw}}

    program_side = {"losses": prog_step_loss, "first": first_grad,
                    "change": {k: after[k] - base[k] for k in base}}
    truth = {}

    def compare(side) -> dict:
        if not truth:
            truth.update(reference())
        k = min(len(truth["losses"]), len(side["losses"]))
        loss_gap = (float(np.max(np.abs(side["losses"][:k]
                                        - truth["losses"][:k])
                                 / np.abs(truth["losses"][:k])))
                    if k else float("inf"))
        grad_gap, grad_median = leaf_gaps(side["first"], truth["first"],
                                          truth["raw"])
        change_gap, change_median = leaf_gaps(side["change"],
                                              truth["change"], truth["raw"])
        return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
                "grad_norm_gap_median": grad_median,
                "change_norm_gap": change_gap,
                "change_norm_gap_median": change_median, "steps": k}

    def check():
        got = compare(program_side)
        lim = wl["limits"]
        return [Check(name, got[name], lim[name]) for name in NUMBERS
                if name in lim
                ] + [Check("steps_short", int(got["steps"] < setup_calls), 0)]

    def control():
        """Every number of the program, and of the control (float8) and the
        faults of a training step, each the reference put in the
        program's place."""
        got = compare(program_side)
        out = {"program": {k: got[k] for k in NUMBERS}}
        for what, kw in (("fp8", {"quant": "fp8"}),
                         ("unchanged", {"fault": "unchanged"}),
                         ("half_batch", {"fault": "half_batch"})):
            got = compare(reference(**kw))
            out[what] = {k: got[k] for k in NUMBERS}
        return out

    return Outcome(end_to_end={"learner_examples_per_s":
                               examples_in / window.wall},
                   attempted=done - setup_calls, extras=extras, check=check,
                   release=holder.clear, control=control)
