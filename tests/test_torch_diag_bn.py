"""The port's `tools/diag_bn_mismatch.py` (`tak_tpu_torch/tools/
diag_bn_mismatch.py`) against the JAX package, on the CPU at 3x3.

A workdir written by the JAX package's `save_training_run`: the perturbed
flax weights of `tests/test_torch_train._start_variables` (n=3, one block
of 8 filters, float32) and 48 examples of seeded 3x3 playouts, generation
4.  Both sides run the tool's steps on it with the chunks cut to 16
examples and 2 chunks a step, as `tests/test_torch_train.py` cuts them:
  * the candidate's weights equal the JAX `Network.train` output within
    `tests/test_torch_train.py`'s float32 tolerance;
  * variant B holds the candidate's parameters and the champion's
    statistics, variant C the reverse, A the candidate;
  * the three `PitResult`s, and the printed lines, equal the JAX pit's:
    both sides on the pool-tier tree kernels (`backend="pallas"`) with the
    exact fake network of `tests/test_torch_search.exact_eval_pair`, 2
    games of 8 sims in waves of 4, K=8, cut to 10 plies, as
    `tests/test_torch_pit.py` runs the pit;
  * an empty buffer: both sides print "buffer 0 examples", keep the
    champion as the candidate and pit it three times with equal results.
The JAX side is built here as `tools/diag_bn_mismatch.py` builds it (the
JAX script sets `jax_default_prng_impl="rbg"` when imported).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tak_tpu.model.network as jax_network_module
import tak_tpu.pit as jax_pit_module
import tak_tpu_torch.model.network as network_module
from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.examples import Example as JaxExample
from tak_tpu.examples import ReplayBuffer as JaxReplayBuffer
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.model.network import LEARNING_RATE
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu.pit import PitConfig as JaxPitConfig
from tak_tpu.pit import pit as jax_pit
from tak_tpu.train_loop import load_training_run as jax_load_training_run
from tak_tpu.train_loop import save_training_run as jax_save_training_run
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.model.network import Network, variables_to_numpy
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.tools import diag_bn_mismatch
from tak_tpu_torch.types import FIELDS

from tests.test_torch_network import playout_states
from tests.test_torch_search import exact_eval_pair
from tests.test_torch_train import _bn_follows, _leaves, _start_variables

N, FILTERS, BLOCKS = 3, 8, 1
CHUNK, IN_STEP, EXAMPLES = 16, 2, 48
STEPS = 2            # one step of 2 chunks, then the trailing flush of 1
GEN, SEED, PIT_SEED = 4, 6, 99
SEARCH = dict(num_sims=8, wave_size=4, max_children=8, backend="pallas")
GAMES, MAX_PLIES = 2, 10


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Chunks of 16 examples, 2 a step, on both sides; one torch thread."""
    for module in (jax_network_module, network_module):
        monkeypatch.setattr(module, "CHUNK_SIZE", CHUNK)
        monkeypatch.setattr(module, "CHUNKS_IN_STEP", IN_STEP)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_examples():
    je, js = playout_states(N, EXAMPLES, 6, seed=1)
    legal = np.asarray(je.batched_legal_mask(js))
    host = jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(1)
    out = []
    for i in range(EXAMPLES):
        acts = np.nonzero(legal[i])[0]
        k = min(len(acts), int(rng.integers(1, 6)))
        out.append(JaxExample(
            state={f: np.asarray(getattr(host, f)[i]) for f in FIELDS},
            actions=np.sort(rng.choice(acts, k, replace=False)).astype(
                np.int32),
            visits=rng.integers(1, 40, k).astype(np.int32),
            result=float(rng.choice([-1.0, 0.0, 1.0]))))
    return out


def jax_net():
    return JaxNetwork(jax_engine(N), JaxNetConfig(
        n=N, filters=FILTERS, blocks=BLOCKS, dtype=jnp.float32))


def write_workdir(path, examples):
    jnet = jax_net()
    buffer = JaxReplayBuffer()
    buffer.extend(examples)
    jax_save_training_run(jax_engine(N), jax.tree.map(
        jnp.asarray, _start_variables(jnet)), buffer, str(path), GEN)
    return jnet


def run_jax(jnet, workdir, games, max_plies, lines):
    """`tools/diag_bn_mismatch.py`'s `main` after its argument parsing, on
    the JAX package, with the tool's pit config cut as `run` cuts it.  Its
    three pits share one JAX `MCTS` (the search is functional, and each
    pit would build the same one), so that the interpret-mode kernels are
    traced and compiled once and not three times."""
    engine = jax_engine(N)
    made = {}

    def one_mcts(engine, eval_fn, config):
        key = (id(engine), id(eval_fn), repr(config))
        if key not in made:
            made[key] = JaxMCTS(engine, eval_fn, config)
        return made[key]

    with mock.patch.object(jax_pit_module, "MCTS", one_mcts):
        return _run_jax(engine, jnet, workdir, games, max_plies, lines)


def _run_jax(engine, jnet, workdir, games, max_plies, lines):
    champion, buffer, gen = jax_load_training_run(engine, jnet, str(workdir))
    lines.append(f"checkpoint: generation {gen}, buffer {len(buffer)} "
                 "examples")
    candidate = jnet.train(champion, buffer.examples,
                           rng=np.random.default_rng([SEED, gen + 1]),
                           passes=1, log=lambda *a: None)
    variants = {
        "A candidate(as-trained)": candidate,
        "B cand-params+champ-stats": {
            "params": candidate["params"],
            "batch_stats": champion["batch_stats"]},
        "C champ-params+cand-stats": {
            "params": champion["params"],
            "batch_stats": candidate["batch_stats"]},
    }
    cfg = JaxPitConfig(games=games, komi=2,
                       search=JaxSearchConfig(**SEARCH), max_plies=max_plies)
    jax_eval, _ = exact_eval_pair(engine.num_actions)
    results = {}
    for name, v in variants.items():
        res = jax_pit(engine, jax_eval, v, champion, cfg, seed=PIT_SEED,
                      log=lambda *a, **k: None)
        results[name] = res
        lines.append(f"{name}: {res}  win_rate={res.win_rate():.3f}")
    return champion, candidate, results


def run_port(workdir, games, max_plies, lines):
    engine = get_engine(N)
    net = Network(engine, NetConfig(n=N, filters=FILTERS, blocks=BLOCKS,
                                    dtype=torch.float32), device="cpu")
    _, torch_eval = exact_eval_pair(engine.num_actions)
    return diag_bn_mismatch.run(
        engine, net, str(workdir), games=games, seed=SEED, pit_seed=PIT_SEED,
        passes=1, search=SearchConfig(**SEARCH), max_plies=max_plies,
        eval_fn=torch_eval, device="cpu", log=lines.append)


def assert_candidate_matches(got, want, start):
    """`tests/test_torch_train.test_train_matches_jax_float32`'s
    tolerance: atol 1e-6, the conv biases a BatchNorm follows within
    2*lr per step, a running mean after such a bias also 1% of its
    difference for each chunk after the first step."""
    got = variables_to_numpy(got)
    w, g, s = _leaves(want["params"]), _leaves(got["params"]), _leaves(
        start["params"])
    assert w.keys() == g.keys()
    for k in w:
        atol = 2 * LEARNING_RATE * STEPS if _bn_follows(k) else 1e-6
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=k)
        assert np.abs(g[k] - s[k]).max() > 0, f"{k} did not move"
    late_chunks = EXAMPLES // CHUNK - IN_STEP
    bias_diff = {k: np.abs(g[k] - w[k]) for k in w if _bn_follows(k)}
    w, g = _leaves(want["batch_stats"]), _leaves(got["batch_stats"])
    for k in w:
        tol = 1e-6
        if k.endswith("['mean']"):
            bias = k.replace("BatchNorm", "Conv").replace("['mean']",
                                                          "['bias']")
            tol = tol + 0.01 * late_chunks * bias_diff[bias]
        assert (np.abs(g[k] - w[k]) <= tol).all(), (k, g[k] - w[k])


def test_diag_matches_jax(tmp_path):
    jnet = write_workdir(tmp_path, jax_examples())
    start = jax.device_get(jax_load_training_run(jax_engine(N), jnet,
                                                 str(tmp_path))[0])
    want_lines, got_lines = [], []
    _, want_cand, want = run_jax(jnet, tmp_path, GAMES, MAX_PLIES,
                                 want_lines)
    out = run_port(tmp_path, GAMES, MAX_PLIES, got_lines)
    assert out["generation"] == GEN and out["examples"] == EXAMPLES
    assert_candidate_matches(out["candidate"], jax.device_get(want_cand),
                             start)

    # B and C from the right halves
    champ, cand, var = out["champion"], out["candidate"], out["variants"]
    assert list(var) == list(want)
    assert var["A candidate(as-trained)"] is cand
    stats = [k for k in champ if k.endswith(diag_bn_mismatch.STATS)]
    assert len(stats) == 3 * (1 + 2 * BLOCKS)
    for k in champ:
        b_src, c_src = (champ, cand) if k in stats else (cand, champ)
        assert var["B cand-params+champ-stats"][k] is b_src[k], k
        assert var["C champ-params+cand-stats"][k] is c_src[k], k
        if not k.endswith("num_batches_tracked"):
            assert not torch.equal(champ[k], cand[k]), f"{k} did not move"

    for name, res in want.items():
        assert vars(out["results"][name]) == vars(res), name
    assert sum(vars(want["A candidate(as-trained)"]).values()) == GAMES
    assert got_lines == want_lines


def test_diag_on_an_empty_buffer_matches_jax(tmp_path):
    """A checkpoint whose buffer is empty, as the default workdir's reads:
    no training on either side, the champion pitted against itself."""
    jnet = write_workdir(tmp_path, [])
    want_lines, got_lines = [], []
    champion, candidate, want = run_jax(jnet, tmp_path, 2, 4, want_lines)
    assert candidate is champion
    out = run_port(tmp_path, 2, 4, got_lines)
    assert out["examples"] == 0 and out["candidate"] is out["champion"]
    for v in out["variants"].values():
        assert all(v[k] is out["champion"][k] for k in v)
    for name, res in want.items():
        assert vars(out["results"][name]) == vars(res), name
    assert got_lines == want_lines
    assert got_lines[0] == f"checkpoint: generation {GEN}, buffer 0 examples"
