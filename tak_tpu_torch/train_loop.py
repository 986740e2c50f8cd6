"""Generational self-play training loop (counterpart of
`tak_tpu/train_loop.py`, train/src/main.rs).

Each generation: train a candidate on the replay buffer, gate it against
the incumbent in pit games (accept at win rate > 0.55, main.rs:28,101),
save accepted models as `_models/<unixtime>.model`, truncate the buffer to
the newest 400,000 examples (main.rs:26,111-115), then run self-play with
the incumbent to extend the buffer, streaming examples to
`_examples/<unixtime>.data` (self_play.rs:98).  `train` returns new
tensors, so the candidate is simply its return value and the incumbent
stays as it was.

Every generation ends with a full-run checkpoint (`_checkpoint/`:
incumbent weights + replay buffer + generation counter, in the JAX
package's format), and `load_training_run` / `cli/train.py --resume`
continue exactly where the run stopped.

With `mesh` (`parallel.mesh.Mesh`, `cli/train.py --sharded`) every rank
runs the loop: self-play is sharded over the ranks and gathered, so that
every rank's buffer holds the same examples; `Network.train` runs data
parallel; the pit runs whole on every rank with the same seed and rank
0's accept/reject decision is broadcast (two ranks whose cuDNN autotunes
chose other algorithms could otherwise disagree at the gate, and their
incumbents would part).  Rank 0 alone writes files and logs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field

import numpy as np

from .examples import ReplayBuffer, example_to_line
from .model.network import Network
from .parallel.mesh import broadcast_flag, replicate
from .pit import PitConfig, pit
from .selfplay import SelfPlayActor, SelfPlayConfig
from .utils.checkpoint import load_run, save_run

MODEL_DIR = "_models"
EXAMPLE_DIR = "_examples"
GAME_DIR = "_games"
CHECKPOINT_DIR = "_checkpoint"


@dataclass
class TrainLoopConfig:
    selfplay: SelfPlayConfig = field(default_factory=SelfPlayConfig)
    pit: PitConfig = field(default_factory=PitConfig)
    max_examples: int = 400_000
    win_rate_threshold: float = 0.55
    # training passes over the buffer per generation (1 = reference
    # parity; >1 for small-buffer regimes where one pass starves the
    # candidate)
    train_passes: int = 1
    generations: int | None = None   # None = loop forever (main.rs:85)
    workdir: str = "."
    checkpoint: bool = True          # write _checkpoint/ every generation


def sys_time() -> int:
    """Unix seconds, used to name artifacts (alpha-tak/src/lib.rs:33-38)."""
    return int(time.time())


def _artifact_path(workdir: str, folder: str, ext: str) -> str:
    """`<workdir>/<folder>/<unix seconds>.<ext>`, with `-1`, `-2`, ... after
    the seconds when that file exists: two generations inside one second
    must not overwrite the first one's file."""
    stem = os.path.join(workdir, folder, str(sys_time()))
    path, i = f"{stem}.{ext}", 0
    while os.path.exists(path):
        i += 1
        path = f"{stem}-{i}.{ext}"
    return path


def save_training_run(engine, variables, buffer: ReplayBuffer, workdir: str,
                      generation: int) -> str:
    """Write the resumable end-of-generation checkpoint."""
    ckpt = os.path.join(workdir, CHECKPOINT_DIR)
    save_run(ckpt, variables=variables,
             meta={"generation": generation, "buffer_len": len(buffer)})
    tmp = os.path.join(ckpt, "buffer.data.tmp")
    buffer.save(engine, tmp)
    os.replace(tmp, os.path.join(ckpt, "buffer.data"))
    return ckpt


def load_training_run(engine, network: Network, workdir: str):
    """Restore (variables, buffer, generation) from `save_training_run`
    (of either package).

    Pass `generation` as training_loop's `start_generation` to continue.
    """
    ckpt = os.path.join(workdir, CHECKPOINT_DIR)
    variables, meta = load_run(ckpt, config=network.config)
    buffer = ReplayBuffer()
    bpath = os.path.join(ckpt, "buffer.data")
    if os.path.exists(bpath):
        buffer.load(engine, bpath)
    return variables, buffer, int(meta.get("generation", 0))


def training_loop(
    engine,
    network: Network,
    variables,
    buffer: ReplayBuffer,
    config: TrainLoopConfig,
    log=print,
    seed: int = 0,
    start_generation: int = 0,
    mesh=None,
):
    """Run generations on the network's device until `config.generations`;
    returns the final incumbent (the same on every rank of `mesh`)."""
    cfg = config
    writer = mesh is None or mesh.rank == 0
    if writer:
        for d in (MODEL_DIR, EXAMPLE_DIR, GAME_DIR):
            os.makedirs(os.path.join(cfg.workdir, d), exist_ok=True)
    else:
        log = lambda *_: None  # noqa: E731
    variables = replicate(mesh, variables)

    eval_fn = network.policy_eval_states
    actor = SelfPlayActor(engine, eval_fn, cfg.selfplay, device=network.device,
                          mesh=mesh)

    generation = start_generation
    while cfg.generations is None or generation < cfg.generations:
        generation += 1
        if len(buffer) >= 1:
            log(f"[gen {generation}] training on {len(buffer)} examples")
            # deterministic per-(seed, generation) shuffle so an
            # interrupted run resumes bit-identically
            candidate = network.train(
                variables, buffer.examples, log=log,
                rng=np.random.default_rng([seed, generation]),
                passes=cfg.train_passes, mesh=mesh,
            )

            log(f"[gen {generation}] pitting candidate vs incumbent")
            gate_pit = dataclasses.replace(
                cfg.pit, decide_threshold=cfg.win_rate_threshold)
            result = pit(engine, eval_fn, candidate, variables, gate_pit,
                         seed=seed + generation, log=log,
                         device=network.device)
            log(f"[gen {generation}] {result} win_rate={result.win_rate():.3f}")
            if broadcast_flag(mesh,
                              result.win_rate() > cfg.win_rate_threshold):
                variables = candidate
                if writer:
                    path = _artifact_path(cfg.workdir, MODEL_DIR, "model")
                    network.save(variables, path)
                    log(f"[gen {generation}] accepted; saved {path}")
            else:
                log(f"[gen {generation}] rejected")

            buffer.truncate()

        log(f"[gen {generation}] starting self-play")
        with contextlib.ExitStack() as stack:
            sink = None
            if writer:
                path = _artifact_path(cfg.workdir, EXAMPLE_DIR, "data")
                f = stack.enter_context(open(path, "w"))

                def sink(ex):
                    f.write(example_to_line(engine, ex) + "\n")

            new_examples = actor.run(
                variables, seed=seed + 1000 + generation, log=log,
                example_sink=sink,
            )
        buffer.extend(new_examples)
        log(f"[gen {generation}] buffer now {len(buffer)} examples")

        if cfg.checkpoint and writer:
            ckpt = save_training_run(
                engine, variables, buffer, cfg.workdir, generation
            )
            log(f"[gen {generation}] checkpoint -> {ckpt}")

    return variables
