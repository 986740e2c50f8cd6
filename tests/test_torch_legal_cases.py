"""The hand-built env cases (`tak_tpu_torch.engine.env_cases`) through the
plain versions of the step with legal bits and of the legal sampler, and
the JAX package's Pallas kernels.

At every size 3-8: `step_legal_plain` against
`build_fused_step_legal(interpret=True)` (one block of all the cases):
the output states, `place` and `spread` (the JAX package's uint32 words
viewed as int32), exactly; and `legal_sampler_plain` with given words
against `build_legal_sampler(..., external_bits=True, interpret=True)`:
action and total, exactly, on the cases' positions and on the positions
their step leaves.  The cases hold disabled rows, finished games (frozen,
their words those of the frozen state), games finished by the step, tall
stacks (heights past n, where a spread's pick-up is capped at n) and full
boards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.pallas_env import (
    build_fused_step_legal,
    build_legal_sampler,
)
from tak_tpu_torch.engine import env_cases
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.engine.env_rollout import legal_sampler_plain
from tak_tpu_torch.engine.fused_env import step_plain
from tak_tpu_torch.engine.legal_bits import step_legal_plain
from tak_tpu_torch.types import ONGOING

from tests.test_torch_engine import assert_states_equal
from tests.test_torch_env_cases import jax_state
from tests.test_torch_legal import words_i32


def case_batch(n):
    names, fields, actions, enabled, _ = env_cases.batch(n)
    return (names, fields, actions, enabled,
            env_cases.as_state(fields, "cpu"))


@pytest.mark.parametrize("n", env_cases.SIZES)
def test_step_legal_cases_vs_pallas(n):
    """`step_legal_plain` == the reference's step-with-legal-bits kernel on
    every case: states and packed words, frozen rows included."""
    je, te = JaxEngine(n), Engine(n)
    names, fields, actions, enabled, state = case_batch(n)
    fused = build_fused_step_legal(je, block_g=len(names), interpret=True)
    want, wplace, wspread = fused(jax_state(fields), jnp.asarray(actions),
                                  jnp.asarray(enabled))
    got, place, spread = step_legal_plain(te, state, torch.as_tensor(actions),
                                          torch.as_tensor(enabled))
    msg = f"{n}x{n} step+legal cases"
    assert_states_equal(want, got, msg)
    assert place.dtype == torch.int32 and spread.dtype == torch.int32
    np.testing.assert_array_equal(place.numpy(), words_i32(wplace),
                                  err_msg=f"{msg} place words")
    np.testing.assert_array_equal(spread.numpy(), words_i32(wspread),
                                  err_msg=f"{msg} spread words")
    # what the cases cover: frozen rows (disabled, or finished on entry)
    # with live words, games the step finishes, stacks past n
    frozen = ~torch.as_tensor(enabled) | (state.result != ONGOING)
    assert int(frozen.sum()) >= 2
    assert bool((spread[frozen] != 0).any())
    assert bool(((got.result != ONGOING) & ~frozen).any())
    assert int(state.heights.max()) > n


@pytest.mark.parametrize("n", env_cases.SIZES)
def test_sampler_cases_vs_pallas(n):
    """`legal_sampler_plain` == the reference's sampler kernel with the same
    words, on the cases' positions and on the positions their step leaves
    (the extremes of the unsigned modulo among the words)."""
    je, te = JaxEngine(n), Engine(n)
    names, fields, actions, enabled, state = case_batch(n)
    R = len(names)
    sampler = build_legal_sampler(je, block_g=R, interpret=True,
                                  external_bits=True)
    stepped = step_plain(te, state, torch.as_tensor(actions),
                         torch.as_tensor(enabled))
    rng = np.random.default_rng(100 + n)
    for what, st in (("positions", state), ("stepped positions", stepped)):
        bits = rng.integers(0, 2 ** 32, R, dtype=np.uint64)
        bits[:2] = [0xFFFFFFFF, 0x80000000]
        want_a, want_t = sampler(jax_state(st.to_numpy()),
                                 jnp.asarray(bits.astype(np.uint32)))
        got_a, got_t = legal_sampler_plain(
            te, st, bits=torch.as_tensor(bits.astype(np.int64)))
        msg = f"{n}x{n} sampler on the cases' {what}"
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t),
                                      err_msg=f"{msg}: totals")
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a),
                                      err_msg=f"{msg}: actions")
        legal = te.legal_mask(st)
        assert torch.equal(got_t, legal.sum(1).to(torch.int32)), msg
        live = got_t > 0
        assert bool(legal[torch.arange(R), got_a.long()][live].all()), msg
