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
               "cli.train", "cli.elo", "native", "playtak.protocol",
               "playtak.bot", "cli.playtak_cli", "parallel.mesh",
               "parallel.learner", "parallel.actor", "utils.warmup",
               "utils.profiling", "cli.warmup", "graft_entry", "tools",
               "tools.quality", "tools.quality_recycle",
               "tools.quality_control", "tools.quality_k",
               "tools.strength_ab", "bench", "tools.timing",
               "tools.profile_selfplay", "tools.profile_move_phases",
               "tools.profile_ab", "tools.profile_recycle_grid",
               "tools.profile_wave", "tools.profile_kernels",
               "tools.profile_hbm", "tools.profile_micro",
               "tools.profile_topk", "tools.profile_topk2",
               "tools.profile_topk3", "tools.profile_nn",
               "tools.diag_bn_mismatch")
PROFILING_TOOLS = tuple(m for m in NEW_MODULES
                        if m.startswith(("tools.profile_", "tools.diag_"))
                        or m == "tools.timing")

# importing a harness runs nothing: no output, no device, no kernel build,
# no argument parsing (each reads its knobs inside `main`)
IMPORT_PROBE = r"""
import sys
import torch
import tak_tpu_torch.kernels.build as kb

def touched(*a, **k):
    raise SystemExit("touched: " + repr(a)[:80])

torch.cuda._lazy_init = touched
torch.cuda.init = touched
kb.build = kb.library = touched
sys.argv = ["probe", "--no-such-flag"]
import importlib
for name in MODULES:
    importlib.import_module("tak_tpu_torch." + name)
assert not torch.cuda.is_initialized()
"""


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


def test_importing_the_profiling_tools_runs_nothing():
    probe = IMPORT_PROBE.replace("MODULES", repr(PROFILING_TOOLS))
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == "" and out.stderr == "", (out.stdout, out.stderr)


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
    # the data-parallel mesh: the card by default, NCCL only on a card
    from tak_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(backend="nccl", device="cpu")
    # the benchmark program, before any tier runs
    from tak_tpu_torch import bench

    with pytest.raises(RuntimeError):
        bench.main([])


def test_training_entry_points_default_to_the_card():
    """`Network.train`, `pit`, the Elo ladder, both training command lines,
    the warm-up command line and the dry run's entry run on the CUDA device
    unless asked for the CPU: without a card they raise."""
    import torch

    from tak_tpu_torch.cli import elo as elo_cli
    from tak_tpu_torch.cli import train as train_cli
    from tak_tpu_torch.cli import warmup as warmup_cli
    from tak_tpu_torch.elo import elo_ladder
    from tak_tpu_torch.graft_entry import entry
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
    with pytest.raises(RuntimeError):
        warmup_cli.main(["--size", "3"])
    with pytest.raises(RuntimeError):
        entry()


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


def test_playtak_entry_points_default_to_the_card(tmp_path):
    """`PlaytakBot` and the playtak command line run on the CUDA device
    unless asked for the CPU: without a card they raise (before any
    connection is opened)."""
    import torch

    from tak_tpu_torch.cli import playtak_cli
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.playtak.bot import BotConfig, PlaytakBot

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = BotConfig(size=3, workdir=str(tmp_path))
    with pytest.raises(RuntimeError):
        PlaytakBot(get_engine(3), None, None, cfg)
    with pytest.raises(RuntimeError):
        playtak_cli.main(["random", "--size", "3", "--host", "127.0.0.1",
                          "--port", "1", "--log-file", ""])
    bot = PlaytakBot(get_engine(3), None, None, cfg, device="cpu")
    assert bot._new_game().game.state.device.type == "cpu"


def test_guardrail_tools_default_to_the_card(tmp_path):
    """The strength A/B (in process and with child rounds) and the three
    quality probes run on the CUDA device unless given `--cpu`: without a
    card they raise, and no child round starts."""
    import torch

    from tak_tpu_torch.tools import (
        quality_control,
        quality_k,
        quality_recycle,
        strength_ab,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tiny = ["--size", "3", "--sims", "8", "--games", "2"]
    for probe in (quality_recycle, quality_control, quality_k):
        with pytest.raises(RuntimeError):
            probe.main(tiny + ["--wave", "4", "--plies", "1"])
    with pytest.raises(RuntimeError):
        strength_ab.main(tiny + ["--blocks", "1"])
    out = tmp_path / "ab.jsonl"
    with pytest.raises(RuntimeError):
        strength_ab.main(tiny + ["--blocks", "1", "--subprocess-rounds",
                                 "--json-out", str(out)])
    assert not out.exists()


def test_profiling_tools_default_to_the_card(tmp_path):
    """Every profiling harness and `diag_bn_mismatch` run on the CUDA device
    unless given `--cpu`: without a card each `main` raises before it
    builds anything."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in PROFILING_TOOLS:
        if name == "tools.timing":
            continue
        tool = importlib.import_module(f"tak_tpu_torch.{name}")
        argv = (["--workdir", str(tmp_path)]
                if name == "tools.diag_bn_mismatch" else [])
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main(argv, {})
