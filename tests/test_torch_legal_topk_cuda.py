"""The legal top-K kernel (`csrc/legal_topk.cu`, through
`engine.legal_bits.legal_topk`) against its plain version
`masked_topk_packed`, bitwise, at the search's shapes: 8,192 rows of 6x6
(9,036 actions) with K 32 and 128 (fewer legal actions than 128 in most
rows: pads), and 8,192 rows of 8x8 (65,216 actions) with K 32.  The rows
are seeded random playouts' positions, their words those of the plain
`legal_bits_plain`; the policies are `chip_smoke.tied_policies` (rows of
four tied levels, all-zero rows and softmax rows), compared in
`chip_smoke.plain_topk`'s row blocks.

Needs a card: every test here is marked `cuda` and skips without one.
On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_legal_topk_cuda.py` (the tests' conftest imports JAX,
which the card's machine lacks; this file does not)."""

import numpy as np
import pytest
import torch

from chip_smoke import plain_topk, playout_states, tied_policies
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.engine.legal_bits import (
    legal_bits_plain,
    legal_topk,
    masked_topk_packed,
)
from tak_tpu_torch.kernels import build as kb

ROWS = 8192


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,ks", [(6, (32, 128)), (8, (32,))])
def test_legal_topk_kernel_bitwise(dev, n, ks):
    """One launch a K, ids and priors bitwise the plain version's in every
    slot of every row."""
    engine = get_engine(n)
    rng = np.random.default_rng(1200 + n)
    states = playout_states(engine, ROWS, 40, rng, dev)
    place, spread = legal_bits_plain(engine, states)
    policy = tied_policies(engine, ROWS, rng, dev)
    legal_n = (engine.legal_mask(states).sum(1)).min().item()
    for k in ks:
        before = kb.LAUNCHES["legal_topk"]
        gv, gi = legal_topk(engine, policy, place, spread, k)
        torch.cuda.synchronize()
        assert kb.LAUNCHES["legal_topk"] == before + 1
        wv, wi = plain_topk(engine, policy, place, spread, k)
        bad = (gi != wi) | (gv.view(torch.int32) != wv.view(torch.int32))
        assert not bool(bad.any()), (
            f"{n}x{n} K={k}: {int(bad.any(1).sum())} of {ROWS} rows differ "
            f"(fewest legal actions in a row: {legal_n})")
        if k == 128 and n == 6:
            assert bool((wv < 0).any()), "no row was padded"


@pytest.mark.cuda
def test_legal_topk_kernel_odd_sizes_and_views(dev):
    """Sizes 3, 5 and 7 (the scalar path), a policy that starts off a
    16-byte boundary, and a bf16 policy (converted first), bitwise."""
    rng = np.random.default_rng(7)
    for n in (3, 5, 7):
        engine = get_engine(n)
        states = playout_states(engine, 512, 20, rng, dev)
        place, spread = legal_bits_plain(engine, states)
        policy = tied_policies(engine, 512, rng, dev)
        for k in (1, 16, 128):
            gv, gi = legal_topk(engine, policy, place, spread, k)
            wv, wi = masked_topk_packed(engine, policy, place, spread, k)
            assert torch.equal(gi, wi) and torch.equal(gv, wv), (n, k)
    engine = get_engine(6)
    states = playout_states(engine, 256, 20, rng, dev)
    place, spread = legal_bits_plain(engine, states)
    A = engine.num_actions
    flat = tied_policies(engine, 256, rng, dev).reshape(-1)
    off = torch.cat([flat.new_zeros(1), flat])[1:].view(256, A)
    assert off.data_ptr() % 16 == 4
    for policy in (off, off.to(torch.bfloat16)):
        gv, gi = legal_topk(engine, policy, place, spread, 32)
        wv, wi = masked_topk_packed(engine, policy, place, spread, 32)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.cuda
def test_legal_topk_kernel_refuses(dev):
    """What the kernel does not take raises; nothing falls back."""
    engine = get_engine(6)
    states = engine.initial_batch(4, 0, dev)
    place, spread = legal_bits_plain(engine, states)
    policy = torch.rand((4, engine.num_actions), device=dev)
    for k in (0, 129):
        with pytest.raises(ValueError):
            legal_topk(engine, policy, place, spread, k)
    with pytest.raises(ValueError):
        legal_topk(engine, policy[:, :100], place, spread, 8)
    with pytest.raises(ValueError):
        legal_topk(engine, policy, place.long(), spread, 8)
