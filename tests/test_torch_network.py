"""PyTorch port's input planes and network against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.observe import observe as jax_observe
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.engine.observe import observe
from tak_tpu_torch.model.network import Network, variables_from_numpy
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.types import GameState

from tests.test_torch_engine import random_actions


def playout_states(n, B, plies, seed):
    je = JaxEngine(n)
    rng = np.random.default_rng(seed)
    js = je.initial_batch(B, 3)
    for ply in range(plies):
        acts = random_actions(rng, np.asarray(je.batched_legal_mask(js)))
        live = rng.random(B) < 0.9
        js = je.batched_step_masked(js, jnp.asarray(acts), jnp.asarray(live))
    return je, js


@pytest.mark.parametrize("n", [5, 6])
def test_observe_planes_exact(n):
    je, js = playout_states(n, 16, 40, seed=n)
    want = np.asarray(jax.vmap(lambda s: jax_observe(je, s))(js))
    got = observe(Engine(n), GameState.from_numpy(js)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resnet_matches_flax_with_folded_bn():
    """2 blocks x 16 filters in float32: flax init (BN statistics
    perturbed so the fold is not trivial) carried over through
    variables_from_numpy.  The policy is compared as log-probabilities
    (a typical probability is about 1/A, so an absolute bound on the
    probabilities themselves could not see a wrong policy head) and the
    value directly, both to atol 1e-4 (float32 convolutions summed in
    another order).  A policy head with permuted channels or transposed
    kernels must miss that bound."""
    n = 6
    jcfg = JaxNetConfig(n=n, filters=16, blocks=2, dtype=jnp.float32)
    jnet = JaxNetwork(JaxEngine(n), jcfg)
    variables = jnet.init_variables(3)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda x: np.abs(np.asarray(x) + rng.normal(0.2, 0.1, x.shape)
                         ).astype(np.float32),
        variables["batch_stats"])
    je, js = playout_states(n, 8, 30, seed=1)
    planes = np.asarray(jax.vmap(lambda s: jax_observe(je, s))(js))
    want_p, want_v = jnet.policy_eval(
        {"params": jax.tree.map(jnp.asarray, params),
         "batch_stats": jax.tree.map(jnp.asarray, stats)}, jnp.asarray(planes))
    want_logp = np.log(np.asarray(want_p))

    tcfg = NetConfig(n=n, filters=16, blocks=2, dtype=torch.float32)
    net = Network(Engine(n), tcfg, device="cpu")
    sd = variables_from_numpy(params, stats, tcfg)
    got_p, got_v = net.policy_eval(sd, torch.as_tensor(np.array(planes)))
    np.testing.assert_allclose(np.log(got_p.numpy()), want_logp, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4,
                               rtol=0)
    # the same through the state entry point
    got_p2, _ = net.policy_eval_states(sd, GameState.from_numpy(js))
    np.testing.assert_allclose(np.log(got_p2.numpy()), want_logp, atol=1e-4,
                               rtol=0)

    # the comparison has teeth: a wrong policy-head layout misses it
    for wrong in (sd["policy.weight"].roll(1, 0),
                  sd["policy.weight"].transpose(2, 3).contiguous()):
        bad_p, _ = net.policy_eval({**sd, "policy.weight": wrong},
                                   torch.as_tensor(np.array(planes)))
        assert np.abs(np.log(bad_p.numpy()) - want_logp).max() > 1e-2
