"""What each rank runs for `tests/test_torch_parallel.py`, and the seeded
inputs both sides share.  Imports the port only (no JAX): spawned ranks
import this module by name."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.examples import Example, ReplayBuffer
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.model.network import Network
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.sizes import input_channels

N, FILTERS, BLOCKS = 3, 8, 1
ROWS = 16                    # the learner step's global batch
CHUNK, IN_STEP, EXAMPLES = 16, 2, 64
SEED = 3
MASK_ROWS = 6                # the legal-mask check's batch over the ranks


def tiny_net(device="cpu") -> Network:
    return Network(Engine(N), NetConfig(n=N, filters=FILTERS, blocks=BLOCKS,
                                        dtype=torch.float32), device=device)


def start_variables(net) -> dict:
    """Seeded weights with moved BatchNorm statistics and biases."""
    sd = net.init_variables(1)
    g = torch.Generator().manual_seed(7)
    for k, v in sd.items():
        if v.is_floating_point():
            v += 0.1 * torch.randn(v.shape, generator=g)
            if k.endswith("running_var"):
                v.abs_()
    return sd


def fake_batch(engine, B=ROWS, seed=0):
    """(planes, pi, z) as float32 numpy: `tests/test_parallel.py`'s."""
    rng = np.random.default_rng(seed)
    A = engine.num_actions
    planes = rng.normal(size=(B, engine.n, engine.n,
                              input_channels(engine.n))).astype(np.float32)
    pi = rng.random((B, A)).astype(np.float32)
    pi = pi / pi.sum(-1, keepdims=True)
    z = rng.choice([-1.0, 0.0, 1.0], size=B).astype(np.float32)
    return planes, pi, z


def varied_examples(count=EXAMPLES, seed=SEED) -> list[dict]:
    """Host examples on positions of seeded random playouts (so that a
    chunk's rows differ and per-rank batch statistics are not global
    ones): sparse visits on legal actions, results in {-1, 0, 1}."""
    engine = Engine(N)
    rng = np.random.default_rng(seed)
    states = engine.initial_batch(count, 0, "cpu")
    for _ in range(int(rng.integers(2, 5))):
        legal = engine.legal_mask(states).numpy()
        acts = np.array([rng.choice(np.nonzero(row)[0]) for row in legal])
        live = rng.random(count) < 0.8
        states = engine.step(states, torch.as_tensor(acts, dtype=torch.int32),
                             torch.as_tensor(live))
    host = states.to_numpy()
    legal = engine.legal_mask(states).numpy()
    out = []
    for i in range(count):
        acts = np.nonzero(legal[i])[0]
        k = min(len(acts), int(rng.integers(1, 6)))
        out.append(dict(
            state={f: v[i].copy() for f, v in host.items()},
            actions=np.sort(rng.choice(acts, k,
                                       replace=False)).astype(np.int32),
            visits=rng.integers(1, 50, k).astype(np.int32),
            result=float(rng.choice([-1.0, 0.0, 1.0]))))
    return out


def selfplay_config(**over):
    from tak_tpu_torch.selfplay import SelfPlayConfig

    play = dict(games=6, workers=4, max_plies=8, noise_plies=4,
                exploit_plies=3,
                search=SearchConfig(num_sims=32, wave_size=4, max_children=8,
                                    node_budget=24, recycle=True))
    play.update(over)
    return SelfPlayConfig(**play)


def gumbel_config():
    return selfplay_config(
        games=2, workers=2, max_plies=5,
        search=SearchConfig(num_sims=8, wave_size=2, max_children=8,
                            gumbel_m=4))


def run_selfplay(config, mesh=None):
    from tak_tpu_torch.graft_entry import exact_eval
    from tak_tpu_torch.selfplay import SelfPlayActor

    engine = Engine(N)
    actor = SelfPlayActor(engine, exact_eval(engine.num_actions), config,
                          device="cpu", mesh=mesh)
    return actor.run(None, seed=5, log=lambda *_: None)


def rank_main(rank, out_dir):
    """Every data-parallel check of one rank; its results go to
    `out_dir/rank<r>.pt`, its training-loop files under
    `out_dir/rank<r>/`."""
    from tak_tpu_torch.parallel.learner import DPLearner
    from tak_tpu_torch.parallel.mesh import (
        all_reduce_grads,
        make_mesh,
        shard_rows,
    )
    from tak_tpu_torch.pit import PitConfig
    from tak_tpu_torch.train_loop import TrainLoopConfig, training_loop

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    net = tiny_net()
    engine = net.engine
    out = {"world": mesh.world, "backend": mesh.backend}

    # (a) one learner step on the global batch, and its summed gradients
    v0 = start_variables(net)
    planes, pi, z = (torch.as_tensor(x) for x in fake_batch(engine))
    learner = DPLearner(net, mesh)
    model = learner.model(v0)
    local = learner.place(planes, pi, z)
    loss, _, _ = net._loss(model, *local, mesh.world)
    loss.backward()
    all_reduce_grads(mesh, model.parameters())
    out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    model = learner.model(v0)
    opt = learner.init_opt_state(model)
    out["step_losses"] = learner.train_step(model, opt, *local)
    out["step_state"] = {k: v.clone() for k, v in model.state_dict().items()}

    # (b) Network.train over the ranks
    examples = [Example(**e) for e in varied_examples()]
    logs = []
    out["train"] = net.train(v0, examples, rng=np.random.default_rng(9),
                             chunk_size=CHUNK, chunks_in_step=IN_STEP,
                             log=logs.append, mesh=mesh)
    out["train_logs"] = logs

    # (c) the batch statistics after one chunk: global, and what each rank
    # would keep on its own rows alone
    pre = net._prestack(examples)
    idx = np.arange(CHUNK)
    for name, m, rows, world in (
            ("bn_global", net._train_model(v0, mesh), shard_rows(mesh, idx),
             mesh.world),
            ("bn_rank", net._train_model(v0), shard_rows(mesh, idx), 1)):
        net._accum_chunk(m, *net._chunk_arrays(pre, rows), world)
        out[name] = {k: v.clone() for k, v in m.state_dict().items()
                     if "running" in k}

    # (d) a sharded self-play generation, and one in Gumbel mode
    out["selfplay"] = run_selfplay(selfplay_config(), mesh)
    out["gumbel"] = run_selfplay(gumbel_config(), mesh)

    # (e) two generations of the training loop; only rank 0 writes
    net.train = functools.partial(net.train, chunk_size=8, chunks_in_step=1)
    search = SearchConfig(num_sims=8, wave_size=4, max_children=16)
    cfg = TrainLoopConfig(
        selfplay=selfplay_config(games=4, workers=4, search=search),
        pit=PitConfig(games=2, komi=0, max_plies=12, search=search),
        generations=2, workdir=os.path.join(out_dir, f"rank{rank}"))
    out["incumbent"] = training_loop(engine, net, net.init_variables(0),
                                     ReplayBuffer(), cfg, log=lambda *_: None,
                                     seed=11, mesh=mesh)

    # (h) `ShardedEnv.legal_mask` on this rank's rows of a fresh batch and
    # after a few random steps (drawn alike on every rank from the gathered
    # masks), with the gathered states beside it
    from tak_tpu_torch.parallel.actor import ShardedEnv

    env = ShardedEnv(engine, mesh, MASK_ROWS, "cpu")
    states = env.initial_batch(half_komi=2)
    rng = np.random.default_rng(SEED)
    masks = []
    for _ in range(4):
        masks.append((env.legal_mask(states), env.gather(states)))
        legal = env.gather(env.legal_mask(states)).numpy()
        acts = np.array([rng.choice(np.nonzero(row)[0]) for row in legal],
                        np.int32)
        states = env.step(states, acts)
    out["legal_mask"] = masks
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))



# the BatchNorm Function over the ranks (`tests/test_torch_batch_norm.py`):
# a float64 batch of BN_SHAPE, rows split over the ranks along N
BN_SHAPE = (6, 16, 3, 3)


def bn_inputs():
    """(x, weight, bias, running_mean, running_var, dy) of the whole batch,
    seeded; a constant channel (3) among them."""
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(BN_SHAPE, generator=g, dtype=torch.float64) * 2 + 0.5
    x[:, 3] = 0.7
    C = BN_SHAPE[1]
    weight = torch.rand(C, generator=g) + 0.5
    bias = torch.randn(C, generator=g)
    running = (torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5)
    dy = torch.randn(BN_SHAPE, generator=g, dtype=torch.float64)
    return x, weight, bias, *running, dy


def bn_run(x, weight, bias, running_mean, running_var, dy, mesh=None):
    """y, the gradients of x, weight and bias, and the running statistics
    after one train-mode forward and backward of the plain Function."""
    from tak_tpu_torch.model.batch_norm import BatchNormPlain

    x = x.clone().requires_grad_()
    weight = weight.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    running_mean, running_var = running_mean.clone(), running_var.clone()
    y = BatchNormPlain.apply(x, weight, bias, running_mean, running_var, mesh)
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dweight": weight.grad,
            "dbias": bias.grad, "running_mean": running_mean,
            "running_var": running_var}


def bn_rank_main(rank, out_dir):
    """This rank's rows of `bn_inputs` through the plain Function with the
    mesh; results to `out_dir/bn_rank<r>.pt`."""
    from tak_tpu_torch.parallel.mesh import make_mesh, shard_rows

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    x, weight, bias, rm, rv, dy = bn_inputs()
    out = bn_run(shard_rows(mesh, x), weight, bias, rm, rv,
                 shard_rows(mesh, dy), mesh)
    torch.save(out, os.path.join(out_dir, f"bn_rank{rank}.pt"))
