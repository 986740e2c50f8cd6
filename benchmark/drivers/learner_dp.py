"""Data-parallel learner cells: the calls, window, spans and comparison of
`drivers/learner.py`, each call `Network.train(..., mesh=)` over the
workload's `world` ranks of a `backend` process group, one rank a card.

Rank 0 is the harness's own process on card 0: it holds the window, the
spans and the trace, and its results are compared.  Ranks 1..W-1 are
started as `python3 -m benchmark.drivers.learner_dp --rank r ...` on
cards 1..W-1, and make the same network, example pool and calls from the
seed.  Every call hands each rank its 1/W of every chunk's examples
(`parallel.mesh.shard_rows`: 125 of 500, 1,000 of the 4,000 symmetry
rows); BatchNorm takes the global batch's statistics and the gradients
are summed over the ranks before each Adam step, so a call is the
single-process step's math, and `drivers/learner.py`'s comparison with
the float32 reference holds it under the same limits.  Two things go
over the group besides the program's own collectives: rank 0's flag at
the start of every call (another call follows, or at the end, none),
and in the set-up calls each chunk's loss, summed over the ranks, so
that rank 0 records the global loss the reference computes.

Every rank pins itself to its own share of the host's cores.  The group
has a timeout (TIMEOUT_S), rank 0 watches the other ranks and ends the
run when one fails, and a rank whose parent is gone exits: a fault or a
hang on either side ends in a non-zero exit within minutes.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, inputs, program

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parents[1]
TIMEOUT_S = 180          # the process group's collectives
JOIN_S = 60              # the other ranks' exit after the last call


def cores_of(rank: int, world: int, cores: list) -> list:
    """Rank `rank`'s share of `cores`: a contiguous 1/W of them (all of
    them where there are fewer cores than ranks)."""
    per = len(cores) // world
    return cores[rank * per:(rank + 1) * per] if per else cores


def device_of(rank: int, cuda: bool) -> torch.device:
    return torch.device("cuda", rank) if cuda else torch.device("cpu")


def join_group(rank: int, world: int, port: int, backend: str, device):
    """This rank's `Mesh` of a new process group over 127.0.0.1:`port`."""
    import torch.distributed as dist

    from tak_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return make_mesh(backend, device)


def leave_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def examples_of(pool: dict) -> list:
    """The pool as the port's `Example`s (as `drivers/learner.py` makes
    them)."""
    from tak_tpu_torch.examples import Example

    fields = [k for k in pool if k not in ("actions", "visits", "z")]
    out = []
    for i in range(len(pool["z"])):
        k = int((pool["visits"][i] > 0).sum())
        out.append(Example(state={f: pool[f][i] for f in fields},
                           actions=pool["actions"][i, :k].copy(),
                           visits=pool["visits"][i, :k].copy(),
                           result=float(pool["z"][i])))
    return out


def on_mesh(nw, mesh, setup_calls: int, announce: bool) -> None:
    """Make every `nw.train` call run on `mesh`, rank 0 first announcing
    it (`announce`; the other ranks wait for it), and make `nw._loss`
    return the loss summed over the ranks in the first `setup_calls`
    calls (its gradient is this rank's own part's, unchanged)."""
    from tak_tpu_torch.parallel.mesh import all_reduce_sum, broadcast_flag

    train, loss_fn = nw.train, nw._loss
    calls = [0]

    def train_on_mesh(variables, examples, **kw):
        if announce:
            broadcast_flag(mesh, True)
        calls[0] += 1
        return train(variables, examples, mesh=mesh, **kw)

    def global_loss(model, planes, pi, z, world=1):
        out = loss_fn(model, planes, pi, z, world)
        if calls[0] > setup_calls:
            return out
        part = out[0].detach()
        return (out[0] + (all_reduce_sum(mesh, part) - part),) + out[1:]

    nw.train = train_on_mesh
    nw._loss = global_loss


def watch(procs: list) -> None:
    """Rank 0's watcher: when another rank exits with a failure before
    the run has ended, kill the rest and end this process (a collective
    with a dead rank would wait out its timeout)."""
    def loop():
        while True:
            for p in procs:
                code = p.poll()
                if code not in (None, 0):
                    harness.note(f"learner_dp: rank pid {p.pid} exited {code}"
                                 "; ending the run")
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    os._exit(1)
            if all(p.poll() is not None for p in procs):
                return
            time.sleep(0.5)

    threading.Thread(target=loop, daemon=True).start()


def run(ctx) -> harness.Outcome:
    wl = ctx.workload
    world, backend = wl["world"], wl["backend"]
    cuda = ctx.device.type == "cuda"
    if cuda and torch.cuda.device_count() < world:
        raise RuntimeError(f"{torch.cuda.device_count()} CUDA devices for "
                           f"{world} ranks")
    cores = sorted(os.sched_getaffinity(0))
    port = _free_port()
    spec = json.dumps({"workload": wl, "config": ctx.config,
                       "seed": ctx.seed, "port": port, "cores": cores,
                       "cuda": cuda})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.drivers.learner_dp", "--rank",
         str(r), "--spec", spec], cwd=CHECKOUT, stdout=subprocess.DEVNULL)
        for r in range(1, world)]
    try:
        watch(procs)
        os.sched_setaffinity(0, cores_of(0, world, cores))
        mesh = join_group(0, world, port, backend, device_of(0, cuda))

        def network(c, tree):
            engine, nw, variables = program.network(c, tree)
            on_mesh(nw, mesh, wl["setup_calls"], announce=True)
            return engine, nw, variables

        base = harness.load_module(HERE / "learner.py",
                                   "benchmark_driver_learner_dp_base")
        base.program = types.SimpleNamespace(**{**vars(program),
                                                "network": network})
        out = base.run(ctx)
        from tak_tpu_torch.parallel.mesh import broadcast_flag

        broadcast_flag(mesh, False)
        leave_group()                 # with the other ranks, at once
        for p in procs:
            code = p.wait(timeout=JOIN_S)
            if code != 0:
                raise RuntimeError(f"rank pid {p.pid} exited {code}")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        leave_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, spec: dict) -> None:
    """Rank `rank` (1..W-1): the same network, pool and calls as rank 0,
    until rank 0 announces none."""
    from tak_tpu_torch.parallel.mesh import broadcast_flag

    wl, c, seed = spec["workload"], spec["config"], spec["seed"]
    world = wl["world"]
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=orphaned, daemon=True).start()
    os.sched_setaffinity(0, cores_of(rank, world, spec["cores"]))
    device = device_of(rank, spec["cuda"])
    mesh = join_group(rank, world, spec["port"], wl["backend"], device)
    try:
        ctx = types.SimpleNamespace(
            config=c, seed=seed, device=device,
            path=lambda rel: CHECKOUT / rel)
        _, nw, current = program.network(ctx, program.flax_weights(ctx))
        on_mesh(nw, mesh, wl["setup_calls"], announce=False)
        per_call = wl["chunk_size"] * wl["chunks_in_step"]
        examples = examples_of(inputs.learner_pool(c["board_size"],
                                                   wl["pool"], seed))
        calls = wl["pool"] // per_call
        done = 0
        while broadcast_flag(mesh, False):
            i = done % calls
            current = nw.train(current, examples[i * per_call:
                                                 (i + 1) * per_call],
                               rng=np.random.default_rng([seed, done]),
                               log=lambda *a, **k: None,
                               chunk_size=wl["chunk_size"],
                               chunks_in_step=wl["chunks_in_step"])
            done += 1
        harness.note(f"learner_dp: rank {rank} done after {done} calls")
    finally:
        leave_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m benchmark.drivers.learner_dp")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    spec = json.loads(args.spec)
    if spec["cuda"]:
        from tak_tpu_torch.utils.device import setup_performance_defaults

        setup_performance_defaults(device_of(args.rank, True))
    rank_main(args.rank, spec)
    # the group is gone; skip the interpreter's teardown of CUDA and NCCL
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
