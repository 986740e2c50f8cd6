"""PyTorch port's rules engine and fused step against the JAX package.

Seeded random playouts (numpy) feed identical positions to both sides;
every comparison is exact (integer state, bool masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.pallas_env import build_fused_step
from tak_tpu.game import Game
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.engine.fused_env import step_plain
from tak_tpu_torch.engine.perft import perft
from tak_tpu_torch.types import FIELDS, GameState

from tests.test_perft import MIDGAME


def jax_to_torch(state) -> GameState:
    return GameState.from_numpy(state, device="cpu")


def assert_states_equal(jax_state, torch_state, msg=""):
    want = {f: np.asarray(getattr(jax_state, f)) for f in FIELDS}
    got = torch_state.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{msg} {f}")


def random_actions(rng, masks):
    return np.array([rng.choice(np.nonzero(m)[0]) if m.any() else 0
                     for m in masks], np.int32)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_playout_parity(n):
    """step, legal_mask, result and wins_in_one agree exactly along seeded
    random playouts (games finish and freeze along the way)."""
    je, te = JaxEngine(n), Engine(n)
    B = 8
    rng = np.random.default_rng(10 + n)
    js = je.initial_batch(B, 3)
    ts = te.initial_batch(B, 3, device="cpu")
    for ply in range(30):
        jm = np.asarray(je.batched_legal_mask(js))
        np.testing.assert_array_equal(te.legal_mask(ts).numpy(), jm,
                                      err_msg=f"legal n={n} ply={ply}")
        acts = random_actions(rng, jm)
        js = je.batched_step(js, jnp.asarray(acts))
        ts = te.step(ts, torch.as_tensor(acts))
        assert_states_equal(js, ts, f"n={n} ply={ply}")
    np.testing.assert_array_equal(
        te.compute_result(ts).numpy(),
        np.asarray(jax.vmap(je.compute_result)(js)))
    jw = np.asarray(jax.vmap(je.wins_in_one)(js))
    np.testing.assert_array_equal(te.wins_in_one(ts).numpy(), jw)


@pytest.mark.parametrize("n,counts", [
    (5, [(0, 1), (1, 25), (2, 600), (3, 43_320)]),
    (6, [(0, 1), (1, 36), (2, 1_260), (3, 132_720)]),
])
def test_perft_openings(n, counts):
    te = Engine(n)
    s = te.initial(0, device="cpu")
    for depth, want in counts:
        assert perft(te, s, depth) == want


@pytest.mark.parametrize("name,size,moves,checks", MIDGAME,
                         ids=[c[0] for c in MIDGAME])
def test_perft_midgame(name, size, moves, checks):
    g = Game.from_ptn_moves(size, moves)
    s = jax_to_torch(jax.tree.map(lambda x: x[None], g.state))
    for depth, want in checks:
        assert perft(Engine(size), s, depth) == want, (name, depth)


def test_plain_fused_step_vs_pallas_interpret():
    """The port's plain fused step == `build_fused_step(interpret=True)` on
    128 rows of varied 6x6 positions: legal actions, disabled rows and
    finished games, exactly."""
    n, R = 6, 128
    je, te = JaxEngine(n), Engine(n)
    rng = np.random.default_rng(7)
    js = je.initial_batch(R, 3)
    for ply in range(60):
        masks = np.asarray(je.batched_legal_mask(js))
        acts = random_actions(rng, masks)
        live = rng.random(R) < (1.0 - ply / 60.0)  # varied game lengths
        js = je.batched_step_masked(js, jnp.asarray(acts), jnp.asarray(live))
    # some games count as finished: the kernel must freeze them
    result = np.asarray(js.result).copy()
    result[::9] = 3
    js = js.replace(result=jnp.asarray(result))
    masks = np.asarray(je.batched_legal_mask(js))
    acts = random_actions(rng, masks)
    enabled = rng.random(R) < 0.8
    fused = build_fused_step(je, block_g=R, interpret=True)
    ref = fused(js, jnp.asarray(acts), jnp.asarray(enabled))
    got = step_plain(te, jax_to_torch(js), torch.as_tensor(acts),
                     torch.as_tensor(enabled))
    assert_states_equal(ref, got, "fused")
