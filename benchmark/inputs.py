"""Inputs the benchmark makes from the seed and hands to both sides.

`learner_pool`: training examples in the layout of the port's replay
buffer (`GameState` fields of one position, sparse visits over actions,
a result), from random boards instead of playouts so that 30,000 of them
cost about a second: each square holds 0-5 pieces of random colours
under a flat (88%) or a wall, some rows a capstone per colour, the
reserves what is left of each colour's pieces; the visits (1-199) fall on
up to MAX_ACTIONS of the position's placements on empty squares and
one-piece spreads of the side to move onto open neighbours.  The same
seed gives the same pool.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tak


HALF_KOMI = 4          # komi 2, as the self-play cells play
MAX_ACTIONS = 32       # visited actions an example holds at most


def learner_pool(n: int, count: int, seed: int) -> dict:
    """Arrays [count, ...]: the ten position fields, `actions` and
    `visits` [count, MAX_ACTIONS] (visits 0 pad), `z` [count], the game's
    result from the side to move."""
    rng = np.random.default_rng([seed, 3])
    stones0, caps0 = tak.START[n]
    n2, W = n * n, tak.words(n)
    heights = rng.choice(6, size=(count, n2),
                         p=[0.35, 0.35, 0.12, 0.08, 0.06, 0.04])
    colours = rng.integers(0, 2, size=(count, n2, 5))
    tops = np.where(rng.random((count, n2)) < 0.88, tak.FLAT, tak.WALL)
    tops = np.where(heights > 0, tops, tak.EMPTY)
    top_colour = np.take_along_axis(
        colours, np.clip(heights - 1, 0, 4)[..., None], 2)[..., 0]
    caps_used = np.zeros((count, 2), np.int64)
    if caps0:
        for c in (0, 1):
            want = rng.random(count) < 0.3
            cand = (heights > 0) & (top_colour == c) & (tops != tak.WALL)
            score = np.where(cand, rng.random((count, n2)), -1.0)
            q = score.argmax(1)
            put = want & (score.max(1) >= 0)
            tops[put, q[put]] = tak.CAP
            caps_used[put, c] = 1
    bits = np.arange(5)[None, None, :] < heights[..., None]
    used = np.stack([((colours == c) & bits).sum((1, 2)) for c in (0, 1)], 1)
    stacks = np.zeros((count, n2, W), np.uint32)
    for h in range(5):
        stacks[..., 0] |= np.where(bits[..., h], colours[..., h], 0).astype(
            np.uint32) << np.uint32(h)
    fields = {
        "stacks": stacks,
        "heights": heights.astype(np.int32),
        "tops": tops.astype(np.int32),
        "to_move": rng.integers(0, 2, count).astype(np.int32),
        "ply": np.maximum(2, heights.sum(1)).astype(np.int32),
        "stones": np.clip(stones0 - used + caps_used, 0,
                          None).astype(np.int32),
        "caps": (caps0 - caps_used).astype(np.int32),
        "half_komi": np.full(count, HALF_KOMI, np.int32),
        "reversible": rng.integers(0, 10, count).astype(np.int32),
        "result": np.zeros(count, np.int32),
    }
    P = tak.num_patterns(n)
    single = 2 ** (n - 1) - 1          # the pattern of one piece, one step
    actions = np.zeros((count, MAX_ACTIONS), np.int32)
    visits = np.zeros((count, MAX_ACTIONS), np.int32)
    for i in range(count):
        empty = np.nonzero(heights[i] == 0)[0]
        cand = [empty, n2 + empty]
        if fields["caps"][i, fields["to_move"][i]] > 0:
            cand.append(2 * n2 + empty)
        mine = np.nonzero((heights[i] > 0)
                          & (top_colour[i] == fields["to_move"][i]))[0]
        for d, (dr, dc) in enumerate(tak.DIRS):
            r, c = mine // n + dr, mine % n + dc
            ok = (r >= 0) & (r < n) & (c >= 0) & (c < n)
            t = np.where(ok, r * n + c, 0)
            ok &= (tops[i][t] != tak.WALL) & (tops[i][t] != tak.CAP)
            cand.append((3 + d * P + single) * n2 + mine[ok])
        cand = np.concatenate(cand)
        if not len(cand):
            cand = np.zeros(1, np.int64)
        k = min(len(cand), int(rng.integers(1, MAX_ACTIONS + 1)))
        pick = np.sort(rng.choice(cand, k, replace=False))
        actions[i, :k] = pick
        visits[i, :k] = rng.integers(1, 200, k)
    fields["actions"] = actions
    fields["visits"] = visits
    fields["z"] = rng.choice([-1.0, 0.0, 1.0], count).astype(np.float32)
    return fields
