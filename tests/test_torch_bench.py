"""The port's benchmark (`tak_tpu_torch/bench.py`) against the JAX package
and the repository's `bench.py`, on the CPU at small sizes.

(a) the MCTS tier's searched trees are the JAX package's search of the
    same roots (`backend="pallas"`, the Pallas kernels in interpret mode:
    what `bench.py` runs on the TPU), bit for bit, with the exact fake
    network of `tests/test_torch_search.py`;
(b) the tier's first evaluation with weights carried from the JAX
    package: priors as log-probabilities and values within 1e-4;
(c) the env tier keeps its games ongoing, conserves pieces and komi;
(d) the program prints exactly one JSON line with `bench.py`'s keys, and
    a failing tier fails the run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu_torch import bench
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts.search import MCTS
from tak_tpu_torch.model.network import Network, variables_from_numpy
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.types import ONGOING

from tests.test_torch_search import (
    assert_node_states_equal,
    assert_trees_equal,
    exact_eval_pair,
)

REPO = Path(__file__).resolve().parents[1]

# bench.py:248-259
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "env_steps_per_s",
              "env_vs_baseline", "device", "config"}
SELFPLAY_KEYS = {"selfplay_sims_per_s", "selfplay_config"}


def jax_roots(engine, batch):
    """`bench.py:135-139` in the JAX package."""
    states = engine.initial_batch(batch, 4)
    states = engine.batched_step(states, jnp.zeros(batch, jnp.int32))
    return engine.batched_step(
        states, jnp.full(batch, engine.num_squares - 1, jnp.int32))


@pytest.mark.parametrize("sims", [32, 64])
def test_mcts_tier_trees_equal_the_pallas_search(sims):
    """4x4, 4 games, wave 8, K=8, the pool tier without recycling, as the
    tier runs 512 x 512 at 6x6: 32 sims (M = 4 x 8 + 2 = 34 nodes) expand
    nearly every root action once; 64 (M = 66) revisit root children and
    go deeper, so that the PUCT constants shape the tree."""
    n, batch, wave, k = 4, 4, 8, 8
    jax_eval, torch_eval = exact_eval_pair(Engine(n).num_actions)
    je = JaxEngine(n)
    jm = JaxMCTS(je, jax_eval, JaxSearchConfig(
        num_sims=sims, wave_size=wave, max_children=k, backend="pallas"))
    roots = jax_roots(je, batch)
    jt = jm.run_sims(None, jm.prepare_root(None, jm.init_batch(roots)))

    config = bench.mcts_config(sims, wave, k)
    assert config.max_nodes == sims + 2 and not config.recycle
    assert MCTS(Engine(n), torch_eval, config).tier == "pool"
    got_roots = bench.mcts_roots(Engine(n), batch, "cpu").to_numpy()
    for f, v in got_roots.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(roots, f)),
                                      err_msg=f"roots {f}")
    rate, trees = bench.mcts_tier(Engine(n), torch_eval, None, "cpu",
                                  batch, sims, wave, k)
    assert rate > 0 and len(trees) == bench.MCTS_REPS + 1
    assert int(np.asarray(jt.n0)[0]) == sims + 1
    for i, tree in enumerate(trees):
        assert_trees_equal(jt, tree, f"tree {i}")
        assert_node_states_equal(jt, tree, f"tree {i}")


def test_mcts_tier_first_evaluation_with_carried_weights():
    """A 2-block, 32-filter float32 net initialised by the JAX package,
    carried over with `variables_from_numpy`: the tier's root priors as
    log-probabilities and the roots' values agree within 1e-4."""
    n, batch = 6, 4
    jcfg = JaxNetConfig(n=n, filters=32, blocks=2, dtype=jnp.float32)
    jnet = JaxNetwork(JaxEngine(n), jcfg)
    variables = jnet.init_variables(0)
    je = JaxEngine(n)
    roots = jax_roots(je, batch)
    jm = JaxMCTS(je, lambda p, s: jnet.policy_eval_states(p, s),
                 JaxSearchConfig(num_sims=512, wave_size=32, max_children=32))
    jt = jm.prepare_root(variables, jm.init_batch(roots))
    _, want_v = jnet.policy_eval_states(variables, roots)

    tcfg = NetConfig(n=n, filters=32, blocks=2, dtype=torch.float32)
    net = Network(Engine(n), tcfg, device="cpu")
    sd = variables_from_numpy(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]), tcfg)
    mcts = MCTS(Engine(n), net.policy_eval_states,
                bench.mcts_config(512, 32, 32))
    tt_roots = bench.mcts_roots(Engine(n), batch, "cpu")
    tree = mcts.prepare_root(sd, mcts.init_batch(tt_roots))
    _, got_v = net.policy_eval_states(sd, tt_roots)
    np.testing.assert_allclose(np.log(tree.root_prior.numpy()),
                               np.log(np.asarray(jt.root_prior)), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(tree.root_legal.numpy(),
                                  np.asarray(jt.root_legal))


def pieces(state):
    return state.heights.sum(-1) + state.stones.sum(-1) + state.caps.sum(-1)


def test_env_tier_keeps_games_ongoing_and_conserves_pieces():
    """What `chip_smoke.env_rollout_phase` checks, on the CPU: 9 launches
    of 8 steps on 64 games, finished games restarted."""
    engine = Engine(6)
    rate, states = bench.env_tier(engine, "cpu", 64, 8)
    start = engine.initial_batch(64, bench.HALF_KOMI, "cpu")
    assert rate > 0
    assert bool((states.result == ONGOING).all())
    assert bool((pieces(states) == pieces(start)).all())
    assert bool((states.half_komi == bench.HALF_KOMI).all())
    assert int(states.ply.max()) > 0


TINY = {"BENCH_SIZE": "3", "BENCH_ENV_BATCH": "8", "BENCH_ENV_STEPS": "4",
        "BENCH_MCTS_BATCH": "2", "BENCH_MCTS_SIMS": "8",
        "BENCH_MCTS_WAVE": "4", "BENCH_MCTS_K": "8", "BENCH_SP_WORKERS": "2",
        "BENCH_SP_SIMS": "8", "BENCH_SP_MOVES": "1", "BENCH_SP_WAVE": "4"}


def run_bench(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(TINY, **extra)
    return subprocess.run([sys.executable, "-m", "tak_tpu_torch.bench",
                           "--cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("sp", ["1", "0"])
def test_program_prints_one_line_with_the_bench_keys(sp):
    out = run_bench(BENCH_SP=sp)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    want = BENCH_KEYS | (SELFPLAY_KEYS if sp == "1" else set())
    assert set(line) == want
    assert line["metric"] == "mcts_sims_per_s_3x3"
    assert line["unit"] == "sims/s" and line["device"] == "cpu"
    assert line["config"] == {"env_batch": 8, "mcts_batch": 2,
                              "mcts_sims": 8, "wave": 4, "k": 8}
    assert line["value"] > 0 and line["env_steps_per_s"] > 0
    assert line["vs_baseline"] == round(line["value"] / 1e5, 3)
    assert line["env_vs_baseline"] == round(line["env_steps_per_s"] / 1e6, 3)
    if sp == "1":
        assert line["selfplay_sims_per_s"] > 0
        assert line["selfplay_config"] == {"workers": 2, "rollouts": 8,
                                           "recycle": True, "wave": 4}
    assert "[bench]" in out.stderr


def test_failing_selfplay_tier_fails_the_run():
    """`bench.py` prints its line without a self-play tier that raised; the
    port exits non-zero and prints no line (wave 0 cannot be searched)."""
    out = run_bench(BENCH_SP_WAVE="0")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "MCTS tier done" in out.stderr


def test_config_reads_the_bench_variables():
    assert bench.BenchConfig.from_env({}) == bench.BenchConfig()
    base = bench.BenchConfig()
    assert (base.size, base.env_batch, base.env_steps, base.mcts_batch,
            base.mcts_sims, base.mcts_wave, base.mcts_k, base.sp,
            base.sp_workers, base.sp_sims, base.sp_moves, base.sp_wave) == (
        6, 8192, 64, 512, 512, 32, 32, True, 32, 10_240, 4, 256)
    cfg = bench.BenchConfig.from_env({**TINY, "BENCH_SP": "0"})
    assert (cfg.size, cfg.mcts_wave, cfg.sp_moves, cfg.sp) == (3, 4, 1,
                                                               False)
    assert bench.mcts_config(512, 32, 32).max_nodes == 514
