"""The port's data-parallel path (`tak_tpu_torch/parallel/`) on two gloo
ranks of the CPU, against the JAX package and against one process.

Mirrors `tests/test_parallel.py`: a tiny float32 net (n=3, 8 filters, 1
block).  One group of two ranks (`tests/torch_parallel_ranks.py`, spawned
once for the module) runs every rank-side check and saves its results;
the tests compare them here with:
  (a) the JAX single-device step on the same numpy batch
      (`tests/test_parallel.py:53-105`'s tolerances);
  (b) `Network.train(mesh=)` against the JAX host loop and the port's own
      single-process train;
  (c) the running statistics after one chunk: global ones equal to one
      process's, per-rank ones not;
  (d) sharded self-play generations (the exact evaluator, with root noise
      and sampled moves; Gumbel mode) equal to one process's, example for
      example, on both ranks;
  (e) the sharded training loop: only rank 0 writes, incumbents equal;
  (h) `ShardedEnv.legal_mask`: each rank's rows of the mask of one
      process holding the gathered batch.
Then (f) `shard_rows` on a batch the ranks do not divide, and (g)
`cli.train --sharded --cpu` under torchrun.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.examples import Example as JaxExample
from tak_tpu.model.network import LEARNING_RATE
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu_torch.examples import Example
from tak_tpu_torch.model.network import variables_to_numpy
from tak_tpu_torch.parallel.mesh import (
    Mesh,
    row_range,
    shard_rows,
    spawn_local,
)
from tak_tpu_torch.types import FIELDS

from tests import torch_parallel_ranks as R
from tests.test_torch_train import _bn_follows, _leaves

REPO = Path(__file__).resolve().parents[1]
RANKS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (`torch_parallel_ranks.rank_main`) and their
    output directory."""
    out = tmp_path_factory.mktemp("ranks")
    spawn_local(R.rank_main, RANKS, (str(out),), backend="gloo",
                timeout_s=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(RANKS)], out


@pytest.fixture(scope="module")
def jax_net():
    return JaxNetwork(JaxEngine(R.N), JaxNetConfig(
        n=R.N, filters=R.FILTERS, blocks=R.BLOCKS, dtype=jnp.float32))


def _flax(state_dict):
    return jax.tree.map(jnp.asarray, variables_to_numpy(state_dict))


def _port_start():
    net = R.tiny_net()
    return net, R.start_variables(net)


def test_dp_step_matches_jax_single_device(ranks, jax_net):
    """(a) the 2-rank `DPLearner` step against the JAX single-device step:
    losses rtol 1e-5, gradients within 1e-2 of each leaf's scale,
    post-Adam parameters rtol 1e-4 / atol 5e-4."""
    results, _ = ranks
    _, v0 = _port_start()
    start = _flax(v0)
    planes, pi, z = (jnp.asarray(x) for x in R.fake_batch(JaxEngine(R.N)))

    def single_step(params, batch_stats, opt_state):
        (_, (_, lp, lz)), grads = jax.value_and_grad(
            jax_net._loss, has_aux=True)(params, batch_stats, planes, pi, z)
        updates, _ = jax_net.optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), grads, lp, lz

    params, grads, lp, lz = jax.jit(single_step)(
        start["params"], start["batch_stats"],
        jax_net.optimizer.init(start["params"]))
    for res in results:
        np.testing.assert_allclose(res["step_losses"], [float(lp), float(lz)],
                                   rtol=1e-5)
        got_g = _leaves(variables_to_numpy({**v0, **res["grads"]})["params"])
        for k, want in _leaves(grads).items():
            tol = 1e-2 * (1.0 + np.abs(want).max())
            assert np.abs(got_g[k] - want).max() <= tol, k
        got = _leaves(variables_to_numpy(res["step_state"])["params"])
        for k, want in _leaves(params).items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=5e-4,
                                       err_msg=k)


def test_network_train_mesh_matches_jax_and_one_process(ranks, jax_net):
    """(b) `Network.train(mesh=)` on 2 ranks against the JAX host loop and
    the port's single-process train (same examples, weights and shuffle):
    rtol 1e-5 / atol 1e-6, but for the conv biases a BatchNorm follows,
    whose gradient is rounding noise that Adam turns into steps of up to
    lr (`tests/test_torch_train.py`'s bound, 2*lr a step).  Both ranks
    return the same variables and log the global loss parts."""
    results, _ = ranks
    net, v0 = _port_start()
    exs = R.varied_examples()
    steps = -(-(R.EXAMPLES // R.CHUNK) // R.IN_STEP)
    kw = dict(chunk_size=R.CHUNK, chunks_in_step=R.IN_STEP)
    logs = []
    one = net.train(v0, [Example(**e) for e in exs],
                    rng=np.random.default_rng(9), log=logs.append, **kw)
    want = jax.device_get(jax_net.train(
        _flax(v0), [JaxExample(**e) for e in exs],
        rng=np.random.default_rng(9), log=lambda m: None, **kw))
    for key in one:
        assert torch.equal(results[0]["train"][key], results[1]["train"][key])
    got = variables_to_numpy(results[0]["train"])
    for ref in (want, variables_to_numpy(one)):
        g, w = _leaves(got["params"]), _leaves(ref["params"])
        for k in w:
            atol = 2 * LEARNING_RATE * steps if _bn_follows(k) else 1e-6
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=atol,
                                       err_msg=k)
    # the logged loss parts are the global means
    for a, b in zip(results[0]["train_logs"], logs):
        if a.startswith("chunk"):
            pa = [float(x.split("=")[1]) for x in a.split()[2:4]]
            pb = [float(x.split("=")[1]) for x in b.split()[2:4]]
            np.testing.assert_allclose(pa, pb, rtol=1e-3)


def test_batchnorm_statistics_are_global(ranks):
    """(c) after one chunk split over 2 ranks the running statistics equal
    one process's on the whole chunk (atol 1e-6); each rank's statistics
    of its own rows alone (plain per-rank BatchNorm) miss them by more than
    100 times that (a chunk moves them by 1% of its batch values)."""
    results, _ = ranks
    net, v0 = _port_start()
    exs = [Example(**e) for e in R.varied_examples()]
    model = net._train_model(v0)
    net._accum_chunk(model, *net._chunk_arrays(net._prestack(exs),
                                               np.arange(R.CHUNK)))
    want = {k: v for k, v in model.state_dict().items() if "running" in k}
    for res in results:
        for k, w in want.items():
            torch.testing.assert_close(res["bn_global"][k], w, rtol=0,
                                       atol=1e-6)
        worst = max(float((res["bn_rank"][k] - w).abs().max())
                    for k, w in want.items())
        assert worst > 100 * 1e-6, worst


def _same_examples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.actions, w.actions)
        np.testing.assert_array_equal(g.visits, w.visits)
        assert g.result == w.result
        for k, v in w.state.items():
            np.testing.assert_array_equal(g.state[k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["selfplay", "gumbel"])
def test_sharded_selfplay_equals_one_process(ranks, mode):
    """(d) 2 ranks of 2 game slots each (root noise drawn for the whole
    batch, moves sampled on the gathered visits, resets, instant wins) or
    1 each in Gumbel mode give exactly one process's examples, in order,
    on both ranks."""
    results, _ = ranks
    config = R.selfplay_config() if mode == "selfplay" else R.gumbel_config()
    want = R.run_selfplay(config)
    assert len(want) > config.games
    for res in results:
        _same_examples(res[mode], want)


def test_sharded_training_loop_writes_from_rank_zero(ranks):
    """(e) two generations of the sharded loop: rank 0 writes the
    checkpoint and the examples, rank 1 writes nothing, and both ranks
    end with the same incumbent."""
    results, out = ranks
    assert (out / "rank0" / "_checkpoint" / "variables.msgpack").exists()
    assert (out / "rank0" / "_checkpoint" / "buffer.data").exists()
    assert len(list((out / "rank0" / "_examples").iterdir())) == 2
    assert not (out / "rank1").exists()
    a, b = (res["incumbent"] for res in results)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sharded_legal_mask_is_the_ranks_rows(ranks):
    """(h) on a fresh batch and after 1-3 random steps, each rank's
    `ShardedEnv.legal_mask` equals its rows of `Engine.legal_mask` on the
    gathered batch, and the ranks' rows tile that batch."""
    results, _ = ranks
    engine = R.tiny_net().engine
    for step in range(len(results[0]["legal_mask"])):
        whole = results[0]["legal_mask"][step][1]
        want = engine.legal_mask(whole)
        assert bool(want.any(-1).all())
        got = []
        for rank, res in enumerate(results):
            mask, gathered = res["legal_mask"][step]
            for f in FIELDS:
                assert torch.equal(getattr(gathered, f), getattr(whole, f))
            rows = row_range(Mesh(None, rank, RANKS, torch.device("cpu"),
                                  "gloo"), R.MASK_ROWS)
            assert torch.equal(mask, want[rows]), (step, rank)
            got.append(mask)
        assert torch.equal(torch.cat(got), want)
        if step:
            assert int(whole.ply.min()) == step


def test_shard_rows_needs_a_divisible_batch():
    """(f) the ranks' row blocks tile the batch in rank order; a batch the
    world size does not divide raises, and so does a sharded quad-rollout
    actor."""
    meshes = [Mesh(None, r, 3, torch.device("cpu"), "gloo") for r in range(3)]
    x = torch.arange(12)
    assert torch.equal(torch.cat([shard_rows(m, x) for m in meshes]), x)
    assert row_range(meshes[2], 6) == slice(4, 6)
    with pytest.raises(ValueError):
        shard_rows(meshes[0], torch.arange(4))
    assert shard_rows(None, x) is x
    # quad rollouts play one game (workers=1): no split over 3 ranks
    with pytest.raises(ValueError):
        R.run_selfplay(R.selfplay_config(workers=1, quad_rollout_plies=4),
                       meshes[0])


def test_cli_train_sharded_under_torchrun(tmp_path):
    """(g) `cli.train --sharded --cpu` as 2 torchrun ranks, one tiny
    generation past the first: the mesh line, the files from rank 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(RANKS), "-m", "tak_tpu_torch.cli.train",
           "random", "--size", "3", "--games", "2", "--workers", "2",
           "--rollouts", "8", "--wave", "4", "--k", "16", "--pit-games", "2",
           "--pit-rollouts", "8", "--chunk-size", "16", "--chunks-in-step",
           "2", "--filters", "8", "--blocks", "1", "--generations", "2",
           "--cpu", "--sharded", "--workdir", str(tmp_path)]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=240,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "mesh: 2 dp ranks (gloo)" in out.stdout
    assert (tmp_path / "_checkpoint" / "variables.msgpack").exists()
    assert len(list((tmp_path / "_examples").iterdir())) == 2
