"""The hand-built env cases (`tak_tpu_torch.engine.env_cases`) through the
port's plain versions and the JAX package's Pallas kernels.

At every size 3-8: the fused step (`build_fused_step(interpret=True)`, one
block of all the cases) against `step_plain`, and three rollout steps with
given words (`build_env_rollout(..., external_bits=True, interpret=True)`)
against `env_rollout_plain`, on every field, exactly.  Each case is first
checked to be the case it was built as: its action is legal, and where it
names a result code, the step gives that code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.pallas_env import build_env_rollout, build_fused_step
from tak_tpu.types import GameState as JaxState
from tak_tpu_torch.engine import env_cases
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.engine.env_rollout import env_rollout_plain
from tak_tpu_torch.engine.fused_env import step_plain
from tak_tpu_torch.types import FIELDS, ONGOING

from tests.test_torch_engine import assert_states_equal

STEPS = 3


def jax_state(fields) -> JaxState:
    return JaxState(**{f: jnp.asarray(fields[f]) for f in FIELDS})


@pytest.mark.parametrize("n", env_cases.SIZES)
def test_cases_are_what_they_claim(n):
    """Every enabled, ongoing case's action is legal in its position, and
    the plain step gives each result code the case names."""
    te = Engine(n)
    names, fields, actions, enabled, expect = env_cases.batch(n)
    state = env_cases.as_state(fields, "cpu")
    legal = te.legal_mask(state)
    live = (state.result == ONGOING) & torch.as_tensor(enabled)
    chosen = legal[torch.arange(len(names)), torch.as_tensor(actions).long()]
    assert bool(chosen[live].all()), [m for m, ok, lv in zip(
        names, chosen.tolist(), live.tolist()) if lv and not ok]
    out = step_plain(te, state, torch.as_tensor(actions),
                     torch.as_tensor(enabled))
    for name, got, want in zip(names, out.result.tolist(), expect):
        assert want is None or got == want, (n, name, got, want)
    frozen = ~live
    for f in FIELDS:
        assert torch.equal(getattr(out, f)[frozen], getattr(state, f)[frozen])
    assert int(state.heights.max()) >= (31 if n >= 5 else 19)


@pytest.mark.parametrize("n", env_cases.SIZES)
def test_step_cases_vs_pallas(n):
    """`step_plain` == the reference's fused step kernel on every case."""
    je, te = JaxEngine(n), Engine(n)
    names, fields, actions, enabled, _ = env_cases.batch(n)
    fused = build_fused_step(je, block_g=len(names), interpret=True)
    want = fused(jax_state(fields), jnp.asarray(actions), jnp.asarray(enabled))
    got = step_plain(te, env_cases.as_state(fields, "cpu"),
                     torch.as_tensor(actions), torch.as_tensor(enabled))
    assert_states_equal(want, got, f"{n}x{n} step cases")


@pytest.mark.parametrize("n", env_cases.SIZES)
def test_rollout_cases_vs_pallas(n):
    """`env_rollout_plain` == the reference's rollout kernel, three steps
    with given words from every case's position (finished rows restart)."""
    je, te = JaxEngine(n), Engine(n)
    names, fields, _, _, _ = env_cases.batch(n)
    R = len(names)
    bits = np.random.default_rng(n).integers(0, 2 ** 32, (STEPS, R),
                                             dtype=np.uint64)
    rollout = build_env_rollout(je, STEPS, block_g=R, interpret=True,
                                external_bits=True)
    want = rollout(jax_state(fields), jnp.asarray(bits.astype(np.uint32)))
    got = env_rollout_plain(te, env_cases.as_state(fields, "cpu"), STEPS,
                            bits=torch.as_tensor(bits.astype(np.int64)))
    assert_states_equal(want, got, f"{n}x{n} rollout cases")
