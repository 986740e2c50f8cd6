"""PyTorch port's `Network.train` against `tak_tpu.model.network.Network.train`.

n=5, one block of 8 filters, 48 examples from seeded random playouts
(sparse visits over legal actions, results in {-1, 0, 1}), chunk size 16
and 2 chunks a step: one optimizer step and the trailing flush.  The same
examples, weights (flax init, perturbed; carried over by
`variables_from_numpy`) and shuffle rng go in on both sides; the JAX side
runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.examples import Example as JaxExample
from tak_tpu.model.network import LEARNING_RATE
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.examples import Example
from tak_tpu_torch.model.network import (
    Network,
    variables_from_numpy,
    variables_to_numpy,
)
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.types import FIELDS, GameState

from tests.test_torch_network import playout_states

N, FILTERS, BLOCKS = 5, 8, 1
CHUNK, IN_STEP, EXAMPLES = 16, 2, 48
STEPS = 2            # one step of 2 chunks, then the trailing flush of 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the tier-1 run
    shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bn_follows(key: str) -> bool:
    """A conv bias that a BatchNorm follows (the stem's and the blocks'):
    the BN subtracts it again, so its gradient is zero up to rounding, and
    Adam turns that noise into steps of up to lr in either direction."""
    return key == "['Conv_0']['bias']" or (
        key.startswith("['ResBlock_") and "['Conv_" in key
        and key.endswith("['bias']"))


def _examples(seed=1):
    """Host example dicts from seeded playouts."""
    je, js = playout_states(N, EXAMPLES, 12, seed)
    legal = np.asarray(je.batched_legal_mask(js))
    host = jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(EXAMPLES):
        acts = np.nonzero(legal[i])[0]
        k = min(len(acts), int(rng.integers(1, 12)))
        out.append(dict(
            state={f: np.asarray(getattr(host, f)[i]) for f in FIELDS},
            actions=np.sort(rng.choice(acts, k, replace=False)).astype(np.int32),
            visits=rng.integers(1, 40, k).astype(np.int32),
            result=float(rng.choice([-1.0, 0.0, 1.0]))))
    return out


def _start_variables(jnet):
    """flax init, perturbed so that biases and statistics are not trivial."""
    v = jax.device_get(jnet.init_variables(3))
    rng = np.random.default_rng(9)
    v = jax.tree.map(
        lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(np.float32), v)
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])
    return v


def _recorded(net, at: slice, parts):
    """Record the (policy, value) loss parts of every chunk: outputs `at`
    of the network's `_accum_chunk`."""
    orig = net._accum_chunk

    def run(*a):
        out = orig(*a)
        parts.append(tuple(float(x) for x in out[at]))
        return out

    net._accum_chunk = run


def _train_both(dtype):
    """(start, JAX variables, port variables (numpy), JAX loss parts, port
    loss parts, port log lines)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    exs = _examples()
    jnet = JaxNetwork(JaxEngine(N), JaxNetConfig(n=N, filters=FILTERS,
                                                 blocks=BLOCKS, dtype=jdt))
    v0 = _start_variables(jnet)
    jparts, tparts, logs = [], [], []
    _recorded(jnet, slice(2, 4), jparts)
    want = jax.device_get(jnet.train(
        jax.tree.map(jnp.asarray, v0), [JaxExample(**e) for e in exs],
        rng=np.random.default_rng(5), chunk_size=CHUNK,
        chunks_in_step=IN_STEP, log=lambda m: None))

    net = Network(Engine(N), NetConfig(n=N, filters=FILTERS, blocks=BLOCKS,
                                       dtype=tdt), device="cpu")
    _recorded(net, slice(0, 2), tparts)
    sd = variables_from_numpy(v0["params"], v0["batch_stats"], net.config)
    before = {k: v.clone() for k, v in sd.items()}
    got = net.train(sd, [Example(**e) for e in exs],
                    rng=np.random.default_rng(5), chunk_size=CHUNK,
                    chunks_in_step=IN_STEP, log=logs.append)
    # the input state_dict is untouched
    for k, v in sd.items():
        assert torch.equal(v, before[k]), k
    return v0, want, variables_to_numpy(got), jparts, tparts, logs


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_matches_jax_float32():
    """float32 on both sides: the loss parts of every chunk to rtol 1e-5,
    the new batch statistics and parameters to atol 1e-6 (float32
    convolutions summed in another order), except the conv biases that a
    BatchNorm follows (`_bn_follows`): within 2*lr per optimizer step; the
    running mean after such a bias also carries 1% of its difference for
    each chunk after the first step."""
    v0, want, got, jparts, tparts, logs = _train_both("f32")
    assert len(jparts) == len(tparts) == EXAMPLES // CHUNK
    np.testing.assert_allclose(tparts, jparts, rtol=1e-5)
    assert sum(l.endswith("step") or l.endswith("(trailing flush)")
               for l in logs) == STEPS
    w, g, s = _leaves(want["params"]), _leaves(got["params"]), _leaves(
        v0["params"])
    assert w.keys() == g.keys()
    for k in w:
        if _bn_follows(k):
            np.testing.assert_allclose(g[k], w[k], atol=2 * LEARNING_RATE
                                       * STEPS, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0,
                                       err_msg=k)
        assert np.abs(g[k] - s[k]).max() > 0, f"{k} did not move"
    # a running mean also takes 1% (flax momentum 0.99) of the difference
    # in the preceding conv bias, for every chunk after the first step
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


def test_train_matches_jax_bf16():
    """bf16 compute, float32 parameters, on both sides.  bf16 keeps 8
    significant bits, and the two frameworks round at other places (XLA
    adds a convolution's bias after rounding its output, oneDNN before):
    the loss parts to rtol 1e-2; every parameter within 2*lr per
    optimizer step (a gradient entry near zero may take the other sign,
    and Adam's first steps move a parameter by about lr whatever the
    gradient's size), with the median entry within lr/10 (most updates
    agree) outside the biases of `_bn_follows`; the batch statistics' moves within 1/32 of their size plus
    1e-6 (each chunk moves a statistic by 1% of a batch value computed in
    float32 from bf16 activations)."""
    v0, want, got, jparts, tparts, _ = _train_both("bf16")
    np.testing.assert_allclose(tparts, jparts, rtol=1e-2)
    w, g = _leaves(want["params"]), _leaves(got["params"])
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= 2 * LEARNING_RATE * STEPS, (k, d.max())
        if not _bn_follows(k):   # those take noise-driven steps anyway
            assert np.median(d) <= LEARNING_RATE / 10, (k, np.median(d))
    w, g, s = (_leaves(want["batch_stats"]), _leaves(got["batch_stats"]),
               _leaves(v0["batch_stats"]))
    for k in w:
        moved = np.abs(w[k] - s[k])
        assert (np.abs(g[k] - w[k]) <= moved / 32 + 1e-6).all(), k


def test_symmetry_expand_and_targets_exact():
    """`_symmetry_expand` and `_build_pi` (through `_prestack` and
    `_chunk_arrays`, gathered in a shuffled order) equal the JAX
    package's bit for bit, and the targets equal `policy_dense`."""
    exs = _examples(2)
    jnet = JaxNetwork(JaxEngine(N), JaxNetConfig(n=N, filters=FILTERS,
                                                 blocks=BLOCKS))
    net = Network(Engine(N), NetConfig(n=N, filters=FILTERS, blocks=BLOCKS),
                  device="cpu")
    idx = np.random.default_rng(4).permutation(EXAMPLES)[:20]
    jsub, jacts, jvis, jz = jnet._chunk_arrays(
        jnet._prestack([JaxExample(**e) for e in exs]), idx)
    sub, acts, vis, z = net._chunk_arrays(
        net._prestack([Example(**e) for e in exs]), idx)
    np.testing.assert_array_equal(acts.numpy(), np.asarray(jacts))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    want_pi = np.asarray(jnet._build_pi(jacts, jvis))
    pi = net._build_pi(acts, vis)
    np.testing.assert_array_equal(pi.numpy(), want_pi)
    dense = np.stack([Example(**exs[i]).policy_dense(Engine(N).num_actions)
                      for i in idx])
    np.testing.assert_array_equal(pi.numpy(), dense)

    planes = net.observe_batch(sub)
    want = jnet._symmetry_expand(jnet.observe_batch(jsub), jnp.asarray(want_pi),
                                 jz)
    got = net._symmetry_expand(planes, pi, z)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].shape[0] == 8 * len(idx)


def test_empty_input_is_a_noop():
    net = Network(Engine(3), NetConfig(n=3, filters=8, blocks=1), device="cpu")
    variables = net.init_variables(0)
    assert net.train(variables, [], log=lambda m: None) is variables


def test_more_passes_take_more_steps():
    """passes=3 walks the examples three times under ONE Adam state: three
    times the step lines, and the parameters move further."""
    exs = [Example(**e) for e in _examples(3)]
    net = Network(Engine(N), NetConfig(n=N, filters=FILTERS, blocks=BLOCKS),
                  device="cpu")
    variables = net.init_variables(0)
    logs1, logs3 = [], []
    one = net.train(variables, exs, rng=np.random.default_rng(1),
                    chunk_size=CHUNK, chunks_in_step=IN_STEP,
                    log=logs1.append)
    three = net.train(variables, exs, rng=np.random.default_rng(1),
                      chunk_size=CHUNK, chunks_in_step=IN_STEP, passes=3,
                      log=logs3.append)

    def steps(logs):
        return sum(" step" in l for l in logs)

    assert steps(logs1) == STEPS
    # 3 passes x 3 chunks = 9 chunks: 4 steps of 2, then the flush of 1
    assert steps(logs3) == 5

    def moved(v):
        return max(float((v[k] - variables[k]).abs().max()) for k in v
                   if v[k].is_floating_point())

    assert moved(three) > moved(one) > 0


def test_train_leaves_its_input_and_eval_cache_alone():
    """`train` returns new tensors; the network's folded inference copy,
    cached by the identity of the variables, then serves the new weights."""
    exs = [Example(**e) for e in _examples(4)]
    net = Network(Engine(N), NetConfig(n=N, filters=FILTERS, blocks=BLOCKS,
                                       dtype=torch.float32), device="cpu")
    variables = net.init_variables(0)
    before = {k: v.clone() for k, v in variables.items()}
    states = GameState.from_numpy({k: np.stack([e.state[k] for e in exs[:4]])
                                   for k in FIELDS})
    p_old, _ = net.policy_eval_states(variables, states)
    new = net.train(variables, exs, rng=np.random.default_rng(0),
                    chunk_size=CHUNK, chunks_in_step=IN_STEP,
                    log=lambda m: None)
    for k, v in variables.items():
        assert torch.equal(v, before[k]), k
        assert new[k].data_ptr() != v.data_ptr()
    p_new, _ = net.policy_eval_states(new, states)
    p_again, _ = net.policy_eval_states(variables, states)
    assert not torch.equal(p_new, p_old)
    assert torch.equal(p_again, p_old)
