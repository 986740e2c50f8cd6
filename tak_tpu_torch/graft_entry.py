"""Entry points of the port's dry run (counterpart of the repository's
`__graft_entry__.py`): the flagship forward, and a data-parallel dry run
over several ranks that holds the learner step and a self-play move
against one process.

    python -m tak_tpu_torch.graft_entry [--ranks 2] [--cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from .engine.core import get_engine
from .model.network import Network
from .model.resnet import NetConfig
from .sizes import input_channels
from .utils.device import resolve_device

SEARCH = dict(num_sims=8, wave_size=2, max_children=16)


def entry(device=None):
    """(fn, example_args): the flagship 6x6 network (16 residual blocks x
    128 filters, conv policy head over 9,036 actions, random weights from
    seed 0) as softmax policy and value of a batch of 32 positions."""
    dev = resolve_device(device)
    network = Network(get_engine(6), device=dev)
    variables = network.init_variables(0)

    def forward(variables, planes):
        return network.policy_eval(variables, planes)

    planes = torch.zeros((32, 6, 6, input_channels(6)), device=dev)
    return forward, (variables, planes)


def exact_eval(num_actions: int):
    """A deterministic fake network (priors and values on a dyadic grid,
    each row a function of its own state): its outputs do not depend on
    which rows share a batch, so a sharded search must equal a whole one
    bit for bit.  `tests/test_torch_search.exact_eval_pair`'s torch side."""
    A = num_actions

    def eval_fn(params, states):
        feat = (states.ply + 2 * states.heights.sum(-1)
                + states.to_move).long()
        k = (feat[:, None] * 7
             + torch.arange(A, device=feat.device)[None, :] * 13) % 61
        return (k + 1).float() / 4096.0, ((feat * 5) % 17 - 8).float() / 16.0

    return eval_fn


def _single_step(network, variables, planes, pi, z):
    """One process's Adam step on the whole batch: (parameters, lp, lz)."""
    model = network._train_model(variables)
    opt = network.make_optimizer(model.parameters())
    loss, lp, lz = network._loss(model, planes, pi, z)
    loss.backward()
    opt.step()
    # copies: the network's train module is loaded anew by its next step
    return ({k: p.detach().float().cpu().clone()
             for k, p in model.named_parameters()}, lp.item(), lz.item())


def _param_dev(a: dict, b: dict) -> float:
    """The largest scale-relative deviation over the parameters."""
    return max(float((a[k] - b[k]).abs().max() / (1.0 + a[k].abs().max()))
               for k in a)


def _loss_dev(ref, got) -> float:
    return max(abs(ref[1] - got[1]) / abs(ref[1]),
               abs(ref[2] - got[2]) / max(abs(ref[2]), 1e-9))


def _one_move(engine, states, mesh=None):
    """One searched move of the dry run's search on `states` (this rank's
    rows under `mesh`): every game's root visits and argmax action."""
    from .mcts.search import MCTS, SearchConfig
    from .mcts.tree import root_visit_counts
    from .parallel.mesh import gather_rows

    mcts = MCTS(engine, exact_eval(engine.num_actions), SearchConfig(**SEARCH))
    tree = mcts.prepare_root(None, mcts.init_batch(states))
    tree = mcts.run_sims(None, tree)
    visits = gather_rows(mesh, root_visit_counts(tree))
    return visits.cpu(), visits.argmax(-1).cpu()


def _dryrun_rank(rank, n, device, out_path):
    from .parallel.actor import ShardedEnv
    from .parallel.learner import DPLearner
    from .parallel.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    mesh = make_mesh(device=dev)
    engine = get_engine(6)
    # the flagship widths in float32, TF32 off: in bf16 (or TF32) a rank's
    # convolution over 2 rows rounds otherwise than one over 2n (another
    # algorithm), and 16 BatchNorms over 2n rows amplify those roundings
    # far past what the row-permutation control (same algorithm) shows
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    network = Network(engine, dataclasses.replace(NetConfig.for_size(6),
                                                  dtype=torch.float32),
                      device=mesh.device)
    variables = network.init_variables(0)
    B = 2 * n                               # two rows / games a rank
    rng = np.random.default_rng(0)
    planes = torch.as_tensor(rng.normal(
        size=(B, 6, 6, input_channels(6))).astype(np.float32))
    pi = rng.random((B, engine.num_actions)).astype(np.float32)
    pi = torch.as_tensor(pi / pi.sum(-1, keepdims=True))
    z = torch.as_tensor(
        rng.choice([-1.0, 0.0, 1.0], size=B).astype(np.float32))
    whole = [x.to(mesh.device) for x in (planes, pi, z)]

    # one process's step, and the same step with the rows reversed: the
    # control measures the float reassociation noise of the net itself
    # (16 BatchNorms over a few rows amplify it), which bounds the
    # sharded step's deviation
    ref = _single_step(network, variables, *whole)
    perm = torch.arange(B - 1, -1, -1, device=mesh.device)
    ctl = _single_step(network, variables, *(x[perm] for x in whole))

    learner = DPLearner(network, mesh)
    model = learner.model(variables)
    opt = learner.init_opt_state(model)
    lp, lz = learner.train_step(model, opt, *learner.place(planes, pi, z))
    got = ({k: p.detach().float().cpu() for k, p in model.named_parameters()},
           lp, lz)
    ctl_param, ctl_loss = _param_dev(ref[0], ctl[0]), _loss_dev(ref, ctl)
    dp_param, dp_loss = _param_dev(ref[0], got[0]), _loss_dev(ref, got)
    if not dp_loss <= 4.0 * ctl_loss + 1e-6:
        raise AssertionError(f"dp loss dev {dp_loss:.2e} > 4x control "
                             f"{ctl_loss:.2e}")
    if not dp_param <= 4.0 * ctl_param + 1e-7:
        raise AssertionError(f"dp param dev {dp_param:.2e} > 4x control "
                             f"{ctl_param:.2e}")

    # one self-play move on this rank's games against one process's move
    env = ShardedEnv(engine, mesh, B, mesh.device)
    states = env.step(env.initial_batch(half_komi=4), np.zeros(B, np.int32))
    masks = env.legal_mask(states)
    visits, actions = _one_move(engine, states, mesh)
    whole_states = engine.step(engine.initial_batch(B, 4, mesh.device),
                               torch.zeros(B, dtype=torch.int32,
                                           device=mesh.device))
    if not torch.equal(masks, engine.legal_mask(whole_states)[env.rows]):
        raise AssertionError("sharded legal mask differs from one process's "
                             "rows")
    ref_visits, ref_actions = _one_move(engine, whole_states)
    if not (torch.equal(visits, ref_visits)
            and torch.equal(actions, ref_actions)):
        raise AssertionError("sharded move's visits/actions differ from one "
                             "process's")
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(dict(ranks=n, device=str(mesh.device),
                           backend=mesh.backend, loss_p=lp, loss_z=lz,
                           dp_param_dev=dp_param, ctl_param_dev=ctl_param,
                           dp_loss_dev=dp_loss, ctl_loss_dev=ctl_loss,
                           visits=int(visits.sum())), f)


def dryrun_multichip(n: int, device="cuda", backend: str | None = None,
                     timeout_s: float = 900.0) -> dict:
    """Spawn `n` ranks; each runs one `DPLearner` step of the flagship Net6
    (in float32) on 2n rows and one sharded self-play move (the exact
    evaluator), and asserts the step within 4x a row-permutation control (plus 1e-6 on
    the loss parts, 1e-7 on the parameters) of one process's step, and
    the move's visits and actions, and the rank's legal mask
    (`ShardedEnv.legal_mask`), equal to one process's.  `device` "cuda"
    puts rank r on card r mod the card count; `backend` defaults to NCCL
    on CUDA and gloo on the CPU (two ranks on one card need gloo).
    Returns rank 0's summary."""
    from .parallel.mesh import spawn_local

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        spawn_local(_dryrun_rank, n, (n, str(device), out), backend=backend,
                    timeout_s=timeout_s)
        with open(out) as f:
            summary = json.load(f)
    print(f"dryrun_multichip({n}): flagship 16x128 Net6 on {summary['device']}"
          f" over {backend} - dp train step loss_p={summary['loss_p']:.3f} "
          f"loss_z={summary['loss_z']:.3f} within 4x the row-permutation "
          f"control (param dev {summary['dp_param_dev']:.1e} vs "
          f"{summary['ctl_param_dev']:.1e}); sharded legal masks and "
          "self-play move visits and actions EXACTLY equal one process's")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, fn_args = entry(device)
    policy, value = fn(*fn_args)
    print(f"entry: policy {tuple(policy.shape)}, value {tuple(value.shape)}")
    dryrun_multichip(args.ranks, device, args.backend)


if __name__ == "__main__":
    main()
