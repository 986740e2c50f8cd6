"""PyTorch port's weights files and run checkpoints against the JAX
package's: each package reads what the other writes, into equal arrays,
and the port writes the bytes flax writes for the same weights."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu.utils.checkpoint import load_run as jax_load_run
from tak_tpu.utils.checkpoint import save_run as jax_save_run
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.model.network import (
    Network,
    variables_from_numpy,
    variables_to_numpy,
)
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.utils.checkpoint import load_run, load_variables, save_run

N, FILTERS, BLOCKS = 5, 16, 2
NET5 = (Path(__file__).resolve().parents[1]
        / "runs/train5_r3/_checkpoint/variables.msgpack")


def _jax_variables(seed=3):
    """flax init, every leaf perturbed (numpy float32 tree)."""
    jnet = JaxNetwork(JaxEngine(N), JaxNetConfig(n=N, filters=FILTERS,
                                                 blocks=BLOCKS))
    v = jax.device_get(jnet.init_variables(seed))
    rng = np.random.default_rng(seed)
    return jnet, jax.tree.map(
        lambda x: np.abs(x + rng.normal(0, 0.1, x.shape)).astype(np.float32),
        v)


def _assert_trees_equal(got, want):
    got = jax.tree_util.tree_leaves_with_path(jax.device_get(got))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(p))


def _port_config():
    return NetConfig(n=N, filters=FILTERS, blocks=BLOCKS)


def test_numpy_round_trip_is_exact():
    _, v = _jax_variables()
    sd = variables_from_numpy(v["params"], v["batch_stats"], _port_config())
    _assert_trees_equal(variables_to_numpy(sd), v)


def test_port_save_is_read_by_jax_and_port(tmp_path):
    jnet, v = _jax_variables()
    net = Network(Engine(N), _port_config(), device="cpu")
    sd = variables_from_numpy(v["params"], v["batch_stats"], net.config)
    path = str(tmp_path / "w.model")
    net.save(sd, path)
    _assert_trees_equal(jnet.load(path), v)
    back = net.load(path)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # the bytes flax writes for the same weights
    jpath = str(tmp_path / "j.model")
    jnet.save(jax.tree.map(jnp.asarray, v), jpath)
    assert Path(path).read_bytes() == Path(jpath).read_bytes()


def test_trained_net5_rewrites_byte_for_byte(tmp_path):
    """The committed Net5 (8 x 128, written by the JAX package) read and
    saved again by the port gives the same file."""
    config = NetConfig.for_size(5)
    path = str(tmp_path / "net5.model")
    Network(Engine(5), config, device="cpu").save(
        load_variables(str(NET5), config), path)
    assert Path(path).read_bytes() == NET5.read_bytes()


def test_save_run_read_both_ways(tmp_path):
    jnet, v = _jax_variables(4)
    config = _port_config()
    sd = variables_from_numpy(v["params"], v["batch_stats"], config)
    meta = {"generation": 3, "buffer_len": 17}

    save_run(str(tmp_path / "port"), variables=sd, meta=meta)
    jvars, opt_state, jmeta = jax_load_run(
        str(tmp_path / "port"), variables_template=jnet.init_variables(0))
    _assert_trees_equal(jvars, v)
    assert opt_state is None and jmeta == meta

    jax_save_run(str(tmp_path / "jax"), variables=jax.tree.map(jnp.asarray, v),
                 meta=meta)
    got, got_meta = load_run(str(tmp_path / "jax"), config=config)
    assert got_meta == meta
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
