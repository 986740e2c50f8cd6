"""PyTorch port's generational loop: resume, artifacts, and the JAX
package reading its checkpoint (mirrors `tests/test_resume.py` and
`tests/test_train_loop.py` at their sizes: 3x3, one block of 8 filters,
2 self-play games and 2 pit games of 8 sims a move in waves of 4, K=16,
chunks of 8, a step per chunk), and the training command line on the CPU.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu.train_loop import load_training_run as jax_load_training_run
from tak_tpu_torch.cli import train as train_cli
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.examples import ReplayBuffer, example_to_line
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.model.network import Network, variables_to_numpy
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.pit import PitConfig
from tak_tpu_torch.selfplay import SelfPlayConfig
from tak_tpu_torch.train_loop import (
    TrainLoopConfig,
    load_training_run,
    training_loop,
)

SEED = 7
QUIET = dict(log=lambda *_: None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the tier-1 run
    shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(workdir, generations, candidates=None):
    """(engine, network, config); the network's `train` appends each
    candidate it returns to `candidates` when given."""
    engine = get_engine(3)
    net = Network(engine, NetConfig(n=3, filters=8, blocks=1), device="cpu")
    train = functools.partial(net.train, chunk_size=8, chunks_in_step=1)

    def recorded(*a, **k):
        out = train(*a, **k)
        if candidates is not None:
            candidates.append(out)
        return out

    net.train = recorded
    cfg = TrainLoopConfig(
        selfplay=SelfPlayConfig(
            games=2, workers=2, komi=0, max_plies=40,
            search=SearchConfig(num_sims=8, wave_size=4, max_children=16),
        ),
        pit=PitConfig(
            games=2, komi=0, max_plies=40,
            search=SearchConfig(num_sims=8, wave_size=4, max_children=16),
        ),
        generations=generations,
        workdir=str(workdir),
    )
    return engine, net, cfg


def _buffer_lines(engine, buffer):
    return [example_to_line(engine, ex) for ex in buffer.examples]


def test_resume_matches_uninterrupted(tmp_path):
    """Two generations straight through equal one generation, then a
    resume from its checkpoint to two: the trained candidate, the
    incumbent, the buffer and the counter."""
    cand_a, cand_b = [], []
    wd_a = tmp_path / "a"
    wd_a.mkdir()
    engine, net_a, cfg_a = _setup(wd_a, generations=2, candidates=cand_a)
    buf_a = ReplayBuffer()
    vars_a = training_loop(engine, net_a, net_a.init_variables(SEED), buf_a,
                           cfg_a, seed=SEED, **QUIET)

    wd_b = tmp_path / "b"
    wd_b.mkdir()
    engine, net_b, cfg_b1 = _setup(wd_b, generations=1)
    buf_b = ReplayBuffer()
    training_loop(engine, net_b, net_b.init_variables(SEED), buf_b, cfg_b1,
                  seed=SEED, **QUIET)

    vars_r, buf_r, gen = load_training_run(engine, net_b, str(wd_b))
    assert gen == 1
    assert len(buf_r) == len(buf_b) > 0
    engine, net_b2, cfg_b2 = _setup(wd_b, generations=2, candidates=cand_b)
    vars_b = training_loop(engine, net_b2, vars_r, buf_r, cfg_b2, seed=SEED,
                           start_generation=gen, **QUIET)

    assert len(cand_a) == len(cand_b) == 1   # generation 2 trained once
    for got, want in ((vars_b, vars_a), (cand_b[0], cand_a[0])):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k].cpu()), k
    assert not torch.equal(cand_a[0]["stem.weight"], vars_r["stem.weight"])
    assert _buffer_lines(engine, buf_a) == _buffer_lines(engine, buf_r)
    meta = json.loads((wd_b / "_checkpoint" / "meta.json").read_text())
    assert meta == {"generation": 2, "buffer_len": len(buf_r)}


def test_checkpoint_artifacts_written_and_read_by_jax(tmp_path):
    """One generation writes `_examples/` and `_checkpoint/`; the JAX
    package's `load_training_run` reads the checkpoint: equal weights,
    the same buffer lines and the generation counter."""
    engine, net, cfg = _setup(tmp_path, generations=1)
    variables = net.init_variables(SEED)
    training_loop(engine, net, variables, ReplayBuffer(), cfg, seed=SEED,
                  **QUIET)
    ckpt = tmp_path / "_checkpoint"
    for name in ("variables.msgpack", "buffer.data", "meta.json"):
        assert (ckpt / name).exists(), name
    data = list((tmp_path / "_examples").iterdir())
    assert len(data) == 1 and data[0].suffix == ".data"

    jnet = JaxNetwork(jax_engine(3), JaxNetConfig(n=3, filters=8, blocks=1))
    jvars, jbuf, jgen = jax_load_training_run(jax_engine(3), jnet,
                                              str(tmp_path))
    assert jgen == 1
    want = variables_to_numpy(variables)
    for (p, a), (q, b) in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(jvars)),
            jax.tree_util.tree_leaves_with_path(want)):
        assert p == q
        np.testing.assert_array_equal(np.asarray(a), b)
    from tak_tpu.examples import example_to_line as jax_line

    lines = (ckpt / "buffer.data").read_text().splitlines()
    assert [jax_line(jax_engine(3), ex) for ex in jbuf.examples] == lines
    _, buf, _ = load_training_run(engine, net, str(tmp_path))
    assert _buffer_lines(engine, buf) == lines


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    """The training command line with `--cpu` at 3x3: one generation (self-
    play only: the buffer starts empty), then `--resume` for a second that
    trains, gates and plays.  A win-rate threshold of -1 settles the gate
    before its first ply (`decide_threshold`) and accepts the candidate,
    so the run saves a model without playing the pit out (the pit has its
    own tests)."""
    args = ["random", "--size", "3", "--games", "2", "--workers", "2",
            "--rollouts", "8", "--wave", "4", "--k", "16", "--pit-games", "2",
            "--pit-rollouts", "8", "--chunk-size", "16", "--chunks-in-step",
            "2", "--filters", "16", "--blocks", "1", "--cpu",
            "--win-rate-threshold", "-1", "--workdir", str(tmp_path)]
    train_cli.main(args + ["--generations", "1"])
    meta = json.loads((tmp_path / "_checkpoint" / "meta.json").read_text())
    assert meta["generation"] == 1 and meta["buffer_len"] > 0
    train_cli.main(args + ["--generations", "2", "--resume"])
    out = capsys.readouterr().out
    assert "at generation 1" in out and "[gen 2] accepted; saved" in out
    meta = json.loads((tmp_path / "_checkpoint" / "meta.json").read_text())
    assert meta["generation"] == 2
    assert len(list((tmp_path / "_examples").iterdir())) == 2
    assert len(list((tmp_path / "_models").iterdir())) == 1
    # quad rollouts are the sequential (--workers 1) self-play's, as in
    # the reference: with 2 workers the actor refuses them
    with pytest.raises(ValueError):
        train_cli.main(args + ["--quad-rollout-plies", "10"])


def test_artifact_names_never_overwrite(tmp_path, monkeypatch):
    """Two generations inside one second name their files apart: the
    examples or model file of the first is never overwritten."""
    from tak_tpu_torch import train_loop

    monkeypatch.setattr(train_loop, "sys_time", lambda: 1_700_000_000)
    (tmp_path / "_examples").mkdir()
    names = []
    for _ in range(3):
        path = train_loop._artifact_path(str(tmp_path), "_examples", "data")
        open(path, "w").close()
        names.append(path.rsplit("/", 1)[1])
    assert names == ["1700000000.data", "1700000000-1.data",
                     "1700000000-2.data"]
