"""The comparisons that decide `correct`, on what the timed path produced.

Each function reads the program's outputs (captured in the window by
`program.py`) and the plain reference's answers for the same inputs, and
returns the numbers that the workload file's `limits` hold:
  * `network`: over the sampled evaluated rows, the widest total-variation
    distance between the program's softmax policy and the float32
    reference's; the widest value gap; the widest gap of the value head's
    output before its tanh, over the larger of 1 and the reference's
    magnitude; and the rows whose value has the other sign than the
    reference's where that is at least VALUE_SIGN_FROM before its tanh;
  * `engine`: positions at which the program's legal moves (the root's
    legal mask), a move it played or an action it searched is not the
    plain rules', or the position it stepped to differs field by field;
  * `search`: searches after which a game's root visits (summed over the
    root's actions, and n0) did not rise by exactly the sims searched, or
    virtual visits were left behind;
  * `tree`: the sampled tree kernel launches replayed by the plain
    reference (`reference/tree.py`) from the tree they started on.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import net, tak
from benchmark.reference import tree as ref_tree

# (move, game) pairs held against the plain rules
ENGINE_PAIRS = 256
# the value's sign is compared where the reference's value before its
# tanh is at least this far from 0
VALUE_SIGN_FROM = 0.5


def network(fields: dict, policy, value, logit, w: dict, n: int, device,
            quant: str | None = None) -> dict:
    """`policy_tv`, `value_gap`, `value_logit_gap` and `value_sign_wrong`
    of the program's rows against the reference on the same positions;
    with `quant` the reference in that precision stands in the program's
    place (the control)."""
    planes = tak.observe(fields, n, device)
    ref_p, ref_v, ref_x = net.policy_value(w, planes)
    if quant is not None:
        policy, value, logit = net.policy_value(w, planes, quant=quant)
    policy, value, logit = (x.to(device).float()
                            for x in (policy, value, logit))
    tv = 0.5 * (policy - ref_p).abs().sum(-1)
    gap = (value - ref_v).abs()
    xgap = (logit - ref_x).abs() / ref_x.abs().clamp(min=1.0)
    far = ref_x.abs() >= VALUE_SIGN_FROM
    sign = far & ((value > 0) != (ref_v > 0))
    return {"policy_tv": float(tv.max()), "value_gap": float(gap.max()),
            "value_logit_gap": float(xgap.max()),
            "value_sign_wrong": int(sign.sum())}


def engine(moves, n: int, rng, limit: int = ENGINE_PAIRS) -> tuple:
    """(positions checked, positions wrong) over a seeded sample of at most
    `limit` of the (move, game) pairs.  `moves`: per move, (fields before,
    actions [B], fields after, root legal mask [B, A], root visits [B, A],
    searched games [B])."""
    pairs = [(m, i) for m, mv in enumerate(moves)
             for i in np.nonzero(mv[5])[0]]
    if len(pairs) > limit:
        pick = rng.choice(len(pairs), limit, replace=False)
        pairs = [pairs[j] for j in sorted(pick)]
    wrong = 0
    for m, i in pairs:
        before, actions, after, legal, visits, _ = moves[m]
        pos = tak.Position.from_fields(before, i, n)
        legal_ref = pos.legal_actions()
        a = int(actions[i])
        want = pos.step(a).fields()
        got = {k: v[i] for k, v in after.items()}
        ok = (set(np.nonzero(legal[i])[0].tolist()) == legal_ref
              and a in legal_ref
              and set(np.nonzero(visits[i])[0].tolist()) <= legal_ref
              and not tak.same_fields(got, want))
        wrong += not ok
    return len(pairs), wrong


def search(log) -> tuple:
    """(searches checked, game-searches wrong).  `log`: per search,
    (root visits before [B], n0 before, root visits after, n0 after,
    virtual visits left [B], sims per game)."""
    wrong = 0
    for pre_n, pre0, post_n, post0, left, sims in log:
        bad = (((post_n - pre_n) != sims) | ((post0 - pre0) != sims)
               | (left != 0))
        wrong += int(bad.sum())
    return len(log), wrong


def tree(samples, recycle: bool) -> tuple:
    """(game-launches replayed, mismatches).  `samples`: per launch and
    game, (tree before, tree after, wave backed up, whether it was
    applied, the leaves and created flags chosen or None)."""
    wrong = sum(ref_tree.replay(before, after, wave, valid, chosen, recycle)
                for before, after, wave, valid, chosen in samples)
    return len(samples), wrong
