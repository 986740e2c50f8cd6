"""The port's SE-ResNet (`NetConfig.se_channels`, `model/squeeze_excite.py`)
against the plain reference `tests/se_resnet_reference.py`, on the CPU at a
tiny size: 16 filters, 2 blocks, 4 SE channels, n = 5 and 8, seeded
weights and seeded random positions.  Also the weights file's flax names,
`config_of`, Net6's blocks unchanged at `se_channels=0`, one self-play
move at 8x8 on the recycling pool tier, and the row blocks of the win
scan and the exact top-K."""

import numpy as np
import pytest
import torch

from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.engine.observe import observe
from tak_tpu_torch.mcts import search
from tak_tpu_torch.model.network import (
    Network,
    config_of,
    variables_from_numpy,
    variables_to_numpy,
)
from tak_tpu_torch.model.resnet import NetConfig, TakResNet
from tak_tpu_torch.model.squeeze_excite import se_epilogue_plain
from tak_tpu_torch.sizes import input_channels, move_channels
from tak_tpu_torch.types import GameState
from tak_tpu_torch.utils.checkpoint import unpackb

from tests import se_resnet_reference as ref

FILTERS, BLOCKS, SE = 16, 2, 4


def config(n, dtype=torch.float32):
    return NetConfig(n=n, filters=FILTERS, blocks=BLOCKS, se_channels=SE,
                     dtype=dtype)


def tree(n, seed=0):
    return ref.random_tree(n, FILTERS, BLOCKS, SE, input_channels(n),
                           move_channels(n), seed)


def random_states(n, rows, plies, seed):
    """`rows` positions after up to `plies` uniformly random legal moves."""
    engine = get_engine(n)
    rng = np.random.default_rng(seed)
    states = engine.initial_batch(rows, 4, device="cpu")
    for _ in range(plies):
        legal = engine.legal_mask(states).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                         for r in legal])
        live = torch.as_tensor(rng.random(rows) < 0.9)
        states = engine.step(states, torch.as_tensor(acts), live)
    return engine, states


def planes_of(n, rows=12, seed=1):
    engine, states = random_states(n, rows, 3 * n, seed)
    return engine, states, observe(engine, states)


@pytest.mark.parametrize("n", [5, 8])
def test_forward_matches_reference(n):
    """Eval mode, unfolded (`TakResNet`) and folded (`Network.policy_eval`,
    the inference path), in float32: logits (log-probabilities for the
    folded net) within 2e-5 of the reference's and values within 1e-6.
    The folded net sums the same float32 products in another order (the
    fold scales the kernels first): about 3e-6 on logits up to 5 here,
    1e-7 on the values; the SE unit's halves (γ, β) swapped move the
    logits by far more than the bound."""
    engine, _, planes = planes_of(n)
    t = tree(n)
    want_logits, want_v = ref.forward(ref.to_torch(t), planes)
    sd = variables_from_numpy(t["params"], t["batch_stats"], config(n))
    model = TakResNet(config(n)).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        logits, v = model(planes)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=2e-5)
    torch.testing.assert_close(v, want_v, rtol=0, atol=1e-6)
    net = Network(engine, config(n), device="cpu")
    probs, v = net.policy_eval(sd, planes)
    torch.testing.assert_close(torch.log(probs), torch.log_softmax(
        want_logits, -1), rtol=0, atol=2e-5)
    torch.testing.assert_close(v, want_v, rtol=0, atol=1e-6)
    # the swapped halves of the second dense layer are far outside
    bad = {k: dict(v) for k, v in t["params"]["ResBlock_0"].items()}
    bad_se = {k: dict(v) for k, v in bad["SqueezeExcite_0"].items()}
    k1 = bad_se["Dense_1"]["kernel"]
    bad_se["Dense_1"]["kernel"] = np.concatenate([k1[:, FILTERS:],
                                                  k1[:, :FILTERS]], 1)
    bad["SqueezeExcite_0"] = bad_se
    params = dict(t["params"], ResBlock_0=bad)
    model.load_state_dict(variables_from_numpy(params, t["batch_stats"],
                                               config(n)))
    with torch.no_grad():
        logits, _ = model(planes)
    assert float((logits - want_logits).abs().max()) > 1e-2


@pytest.mark.parametrize("n", [5, 8])
def test_train_loss_and_gradients_match_reference(n):
    """Train mode (batch statistics, `Network._loss`) in float32: the loss
    within 1e-5 and every leaf's gradient within 1e-4 of the largest
    entry of that leaf's reference gradient plus 1e-6 of the largest entry
    of any leaf (float32 sums in another order; the batch-statistics
    backward cancels terms, so relative to the leaf rather than to each
    entry, and a convolution's bias before a train-mode BatchNorm has a
    gradient of 0 up to that rounding).
    The SE leaves reach the port through `variables_from_numpy` and come
    back through `variables_to_numpy` under their flax names."""
    engine, states, planes = planes_of(n, rows=16, seed=2)
    rng = np.random.default_rng(3)
    A = engine.num_actions
    pi = torch.as_tensor(rng.random((16, A)), dtype=torch.float32)
    pi = pi * engine.legal_mask(states)
    pi = pi / pi.sum(-1, keepdim=True).clamp(min=1e-9)
    z = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], 16), dtype=torch.float32)
    t = tree(n, seed=4)
    rt = ref.to_torch(t, requires_grad=True)
    want, _, _ = ref.loss(rt, planes, pi, z)
    want.backward()

    model = TakResNet(config(n)).train()
    model.load_state_dict(variables_from_numpy(t["params"], t["batch_stats"],
                                               config(n)))
    got, _, _ = Network._loss(model, planes, pi, z)
    got.backward()
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    grads = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        grads[name] = p.grad
    got_tree = variables_to_numpy(grads)["params"]

    def leaves(b):
        if isinstance(b, dict):
            return [x for v in b.values() for x in leaves(v)]
        return [float(b.grad.abs().max())]

    largest = max(leaves(rt["params"]))

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        want_g = b.grad.numpy()
        err = float(np.abs(a - want_g).max())
        bound = 1e-4 * float(np.abs(want_g).max()) + 1e-6 * largest
        assert err <= bound, (path, err, bound)

    walk(got_tree, rt["params"])
    assert "SqueezeExcite_0" in got_tree["ResBlock_1"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_epilogue_plain_matches_reference_block(dtype):
    """The epilogue's CPU path against the reference's SE unit at 8x8 x 16
    channels: float32 within 1e-6 (the same operations, the means summed
    in another order); bf16 inputs give the reference's float32 result
    rounded once to bf16, within one bf16 step (2^-7 of the value)."""
    rng = np.random.default_rng(5)
    R, C, S, n = 6, FILTERS, SE, 8
    y = torch.as_tensor(rng.standard_normal((R, C, n, n)), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal((R, C, n, n)), dtype=dtype)
    p = ref.to_torch({
        "Dense_0": {"kernel": rng.standard_normal((C, S)) / 4,
                    "bias": 0.1 * rng.standard_normal(S)},
        "Dense_1": {"kernel": rng.standard_normal((S, 2 * C)) / 2,
                    "bias": 0.1 * rng.standard_normal(2 * C)}})
    want = ref.squeeze_excite(y.float(), x.float(), p)
    got = se_epilogue_plain(
        y, x, p["Dense_0"]["kernel"].t().contiguous(), p["Dense_0"]["bias"],
        p["Dense_1"]["kernel"].t().contiguous(), p["Dense_1"]["bias"])
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    else:
        err = (got.float() - want).abs()
        assert bool((err <= want.abs() * 2.0 ** -7 + 1e-6).all())
        assert float((got.float() - want.to(dtype).float()).abs().max()) \
            <= float(want.abs().max()) * 2.0 ** -7


def test_weights_file_round_trip_and_config_of(tmp_path):
    """`Network.save`/`load` through the flax msgpack bytes: the SE leaves
    under `ResBlock_i/SqueezeExcite_0/Dense_{0,1}` with flax's [in, out]
    kernels, every tensor back bit for bit, and `config_of` recovering the
    widths and `se_channels`."""
    n = 5
    engine = get_engine(n)
    net = Network(engine, config(n), device="cpu")
    variables = net.init_variables(7)
    path = str(tmp_path / "se.model")
    net.save(variables, path)
    with open(path, "rb") as f:
        flax = unpackb(f.read())
    se = flax["params"]["ResBlock_1"]["SqueezeExcite_0"]
    assert se["Dense_0"]["kernel"].shape == (FILTERS, SE)
    assert se["Dense_1"]["kernel"].shape == (SE, 2 * FILTERS)
    np.testing.assert_array_equal(
        se["Dense_0"]["kernel"],
        variables["blocks.1.se.dense0.weight"].numpy().T)
    back = net.load(path)
    assert set(back) == set(variables)
    for k, v in variables.items():
        assert torch.equal(back[k], v), k
    got = config_of(back)
    assert (got.n, got.filters, got.blocks, got.se_channels) == (
        n, FILTERS, BLOCKS, SE)


def test_se_channels_zero_is_the_plain_block():
    """At `se_channels=0` the model has exactly Net6's state_dict keys (no
    SE leaf) and its blocks compute relu(bn1(conv1(relu(bn0(conv0(x))))) +
    x) bit for bit; `config_of` gives 0 back."""
    n = 6
    cfg = NetConfig(n=n, filters=FILTERS, blocks=BLOCKS, dtype=torch.float32)
    model = TakResNet(cfg).eval()
    keys = {"stem.weight", "stem.bias", "policy.weight", "policy.bias",
            "value.weight", "value.bias"}
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    keys |= {f"stem_bn.{k}" for k in bn}
    for i in range(BLOCKS):
        for j in range(2):
            keys |= {f"blocks.{i}.conv{j}.weight", f"blocks.{i}.conv{j}.bias"}
            keys |= {f"blocks.{i}.bn{j}.{k}" for k in bn}
    sd = Network(get_engine(n), cfg, device="cpu").init_variables(1)
    assert set(model.state_dict()) == keys == set(sd)
    model.load_state_dict(sd)
    _, _, planes = planes_of(n, rows=8, seed=6)
    with torch.no_grad():
        x = torch.relu(model.stem_bn(model.stem(planes.permute(0, 3, 1, 2))))
        for b in model.blocks:
            y = torch.relu(b.bn0(b.conv0(x)))
            x = torch.relu(b.bn1(b.conv1(y)) + x)
        logits, v = model(planes)
        want_v = torch.tanh(model.value(x.reshape(8, -1)))[:, 0]
    assert torch.equal(logits, model.policy(x).reshape(8, -1))
    assert torch.equal(v, want_v)
    assert config_of(sd).se_channels == 0


def test_selfplay_move_at_8x8_on_the_pool_tier():
    """`SelfPlayActor.run` -> `MCTS.run_sims` at 8x8 with an SE net takes
    the recycling pool tier and plays a searched move in every game: each
    example's visits sum to the sims searched, on legal actions."""
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig

    n = 8
    engine = get_engine(n)
    net = Network(engine, config(n), device="cpu")
    variables = net.init_variables(2)
    scfg = SearchConfig(num_sims=16, wave_size=4, max_children=8,
                        recycle=True)
    # the two opening plies, then one searched move a game
    cfg = SelfPlayConfig(games=2, workers=2, komi=2, search=scfg,
                         max_plies=3, instant_win_scan=True, tree_reuse=True)
    actor = SelfPlayActor(engine, net.policy_eval_states, cfg, device="cpu")
    assert actor.mcts.tier == "pool"
    examples = actor.run(variables, seed=3, log=lambda *a, **k: None)
    assert len(examples) == 2
    for e in examples:
        assert int(e.visits.sum()) == 16
        state = GameState.from_numpy({k: v[None] for k, v in e.state.items()})
        legal = np.flatnonzero(engine.legal_mask(state)[0].numpy())
        assert set(e.actions.tolist()) <= set(legal.tolist())


def test_win_scan_and_topk_blocks_equal_the_unsplit_result(monkeypatch):
    """`wins_in_one` in blocks of games and the exact `masked_topk` in
    blocks of rows give the unsplit results bit for bit at 8x8."""
    from tak_tpu_torch.engine import core

    n = 8
    engine, states = random_states(n, 5, 40, seed=8)
    A = engine.num_actions
    monkeypatch.setattr(core, "WIN_SCAN_ROWS", 5 * A)
    whole = engine.wins_in_one(states)
    for rows in (A, 2 * A):
        monkeypatch.setattr(core, "WIN_SCAN_ROWS", rows)
        assert torch.equal(engine.wins_in_one(states), whole)
    rng = np.random.default_rng(9)
    policy = torch.softmax(torch.as_tensor(
        rng.standard_normal((7, A)), dtype=torch.float32), -1)
    legal = engine.legal_mask(random_states(n, 7, 10, seed=10)[1])
    vals, ids = search.masked_topk(policy, legal, 16)
    monkeypatch.setattr(search, "TOPK_KEYS", 3 * A)
    v2, i2 = search.masked_topk(policy, legal, 16)
    assert torch.equal(vals, v2) and torch.equal(ids, i2)
