"""The port's warm-up (`utils/warmup.py`, `cli/warmup.py`) and profiling
(`utils/profiling.py`) on the CPU.  The warm-up runs the tiny config of
`tests/test_warmup.py` on both packages: the port logs the JAX package's
stage names, in its order (the kernel build, a stage of its own on CUDA
only, does not run here)."""

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu.pit import PitConfig as JaxPitConfig
from tak_tpu.selfplay import SelfPlayConfig as JaxSelfPlayConfig
from tak_tpu.utils.warmup import warmup_generation as jax_warmup_generation
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.model.network import Network
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.pit import PitConfig
from tak_tpu_torch.selfplay import SelfPlayConfig
from tak_tpu_torch.utils.profiling import trace
from tak_tpu_torch.utils.warmup import warmup_generation

REPO = Path(__file__).resolve().parents[1]
SEARCH = dict(num_sims=8, wave_size=2, max_children=16)
CLI = ["--cpu", "--size", "3", "--workers", "4", "--rollouts", "8",
       "--wave", "2", "--k", "16", "--pit-games", "4", "--pit-rollouts", "8",
       "--chunk-size", "4", "--filters", "8", "--blocks", "1"]


def _stages(lines):
    """The stage names of `[warmup] <name>: <t>s` lines, and `total`."""
    out = []
    for line in lines:
        m = re.match(r"\[warmup\] (.+?):? [0-9.]+s$", line)
        if m:
            out.append(m.group(1))
    return out


def test_warmup_generation_names_the_jax_stages():
    jax_logs = []
    jax_warmup_generation(
        jax_engine(3), JaxNetwork(jax_engine(3), JaxNetConfig(
            n=3, filters=8, blocks=1)),
        JaxSelfPlayConfig(workers=4, komi=2,
                          search=JaxSearchConfig(**SEARCH)),
        JaxPitConfig(games=4, komi=2, search=JaxSearchConfig(**SEARCH)),
        chunk_size=4, log=jax_logs.append)
    logs = []
    engine = get_engine(3)
    warmup_generation(
        engine, Network(engine, NetConfig(n=3, filters=8, blocks=1),
                        device="cpu"),
        SelfPlayConfig(workers=4, komi=2, search=SearchConfig(**SEARCH)),
        PitConfig(games=4, komi=2, search=SearchConfig(**SEARCH)),
        chunk_size=4, log=logs.append)
    want = _stages(jax_logs)
    assert "run_sims (the big one)" in want and want[-1] == "total"
    assert _stages(logs) == want


def test_warmup_cli_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "tak_tpu_torch.cli.warmup",
                          *CLI], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    stages = _stages(out.stdout.splitlines())
    for name in ("masked_step", "run_sims (the big one)", "move_bundle",
                 "train chunk (4)", "optimizer step", "pit run_sims",
                 "total"):
        assert name in stages, (name, stages)


def test_trace_writes_a_chrome_trace(tmp_path):
    engine = get_engine(3)
    states = engine.initial_batch(4, 0, "cpu")
    with trace(str(tmp_path), log=lambda *_: None) as prof:
        engine.step(states, torch.zeros(4, dtype=torch.int32))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert prof.key_averages()
