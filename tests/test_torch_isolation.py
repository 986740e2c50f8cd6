"""The PyTorch port stands alone: no JAX, flax, msgpack or tak_tpu module
is loaded by importing it (every module, the command lines included), and
asking for a missing CUDA device raises at every entry point."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import tak_tpu_torch
for m in pkgutil.walk_packages(tak_tpu_torch.__path__, "tak_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(name for name in sys.modules
             if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "msgpack", "orbax", "tak_tpu"))
print("MODULES", len([n for n in sys.modules if n.startswith("tak_tpu_torch")]))
print("BAD", ",".join(bad))
print("HAVE", ",".join(sorted(n for n in sys.modules
                              if n.startswith("tak_tpu_torch."))))
"""

NEW_MODULES = ("analysis", "errors", "game", "player", "engine.tps",
               "engine.ptn", "mcts.tree_kernels_hbm", "utils.checkpoint",
               "cli.analysis_cli", "cli.tei", "engine.legal_bits",
               "engine.env_rollout", "examples", "pit", "train_loop", "elo",
               "cli.train", "cli.elo")


def test_port_imports_no_jax_or_tak_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if " " in line)
    assert int(lines["MODULES"]) >= 25
    assert lines["BAD"].strip() == "", lines["BAD"]
    have = lines["HAVE"].split(",")
    for name in NEW_MODULES:
        assert f"tak_tpu_torch.{name}" in have, name


def test_cuda_request_without_card_raises():
    import torch

    from tak_tpu_torch.engine.core import Engine
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Engine(6).initial_batch(2)  # the default device is cuda
    with pytest.raises(RuntimeError):
        Network(Engine(6))
    assert resolve_device("cpu").type == "cpu"


def test_training_entry_points_default_to_the_card():
    """`Network.train`, `pit`, the Elo ladder and both training command
    lines run on the CUDA device unless asked for the CPU: without a card
    they raise."""
    import torch

    from tak_tpu_torch.cli import elo as elo_cli
    from tak_tpu_torch.cli import train as train_cli
    from tak_tpu_torch.elo import elo_ladder
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig
    from tak_tpu_torch.pit import pit

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    engine = get_engine(3)
    config = NetConfig(n=3, filters=8, blocks=1)
    variables = Network(engine, config, device="cpu").init_variables(0)
    with pytest.raises(RuntimeError):
        Network(engine, config).train(variables, [])
    with pytest.raises(RuntimeError):
        pit(engine, None, None, None)
    with pytest.raises(RuntimeError):
        elo_ladder(engine, None, [("a", None), ("b", None)])
    with pytest.raises(RuntimeError):
        train_cli.main(["random", "--size", "3"])
    with pytest.raises(RuntimeError):
        elo_cli.main(["random", "random", "--size", "3"])


def test_player_entry_points_default_to_the_card():
    """`Game`, the codecs and both command lines run on the CUDA device
    unless asked for the CPU: without a card they raise."""
    import torch

    from tak_tpu_torch.cli import analysis_cli, tei
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.engine.ptn import parse_ptn
    from tak_tpu_torch.engine.tps import tps_to_state
    from tak_tpu_torch.game import Game

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Game(3)
    with pytest.raises(RuntimeError):
        tps_to_state(get_engine(3), "x3/x3/x3 1 1")
    with pytest.raises(RuntimeError):
        parse_ptn(get_engine(3), "1. a1 c3")
    with pytest.raises(RuntimeError):
        tei.main(["random", "--size", "3"])
    with pytest.raises(RuntimeError):
        analysis_cli.main(["3", "random", "--example-game"])
    assert Game(3, device="cpu").state.device.type == "cpu"
