"""Self-play cells: `SelfPlayActor.run` of the port, games in lockstep with
an unbounded game quota, so that every slot is always live.

Set-up: the network and its weights, the actor, then `warm_moves` whole
moves (the first pays cuDNN's autotuning at the cell's two shapes, the
roots' and the waves').  The window opens when the last warm search ends
and closes at the end of the first search that ends `seconds` after it;
`selfplay_sims_per_s` is the descents of the searches in between (each
game's sims a search, as `MCTS.run_sims` runs them, times the games) over
that wall time, move tails included.

Spans: `search` (`MCTS.run_sims`), `prepare_root`, `eval` (the evaluation
callable handed to the search), `move_tail` (`SelfPlayActor._move_tail`).
Captured for the comparison: a seeded sample of evaluated rows and of
the pool tier's kernel launches (`program.py`); each move's position,
action, successor, root legal mask and root visits; each search's root
visit counts before and after.
"""

from __future__ import annotations

import numpy as np

from benchmark import checks, program
from benchmark.harness import Check, Outcome, Stop
from benchmark.reference import net


def sims_per_search(cfg) -> int:
    """Descents a game's search makes: whole chunks of waves, as
    `MCTS.run_sims` runs them (`SearchConfig.scan_chunk`)."""
    total = cfg.num_waves
    chunk = total
    if cfg.scan_chunk:
        chunk = min(total, -(-cfg.scan_chunk // cfg.wave_size))
    return -(-total // chunk) * chunk * cfg.wave_size


def run(ctx) -> Outcome:
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig

    wl, c = ctx.workload, ctx.config
    tree = program.flax_weights(ctx)
    engine, nw, variables = program.network(ctx, tree)
    search_cfg = SearchConfig(num_sims=wl["sims"], wave_size=wl["wave"],
                              max_children=wl["k"], recycle=wl["recycle"])
    cfg = SelfPlayConfig(
        games=10 ** 12, workers=wl["workers"], komi=wl["komi"],
        search=search_cfg, noise_alpha=wl["noise_alpha"],
        noise_ratio=wl["noise_ratio"], noise_plies=wl["noise_plies"],
        exploit_plies=wl["exploit_plies"],
        instant_win_scan=wl["instant_win_scan"],
        tree_reuse=wl["tree_reuse"])
    tap = program.EvalTap(ctx, nw)
    actor = SelfPlayActor(engine, tap, cfg, device=ctx.device)
    mcts = actor.mcts
    if mcts.tier != "pool":
        raise ValueError(f"the search takes the {mcts.tier} tier; the "
                         "comparison replays the pool tier's kernels only")
    kernels = program.KernelTap(ctx, recycle=wl["recycle"])
    B = wl["workers"]
    per_game = sims_per_search(actor.search_config)
    st = {"searches": 0, "sims": 0, "moves": 0}
    search_log, moves = [], []
    rec, window = ctx.rec, ctx.window

    run_sims, prepare_root = mcts.run_sims, mcts.prepare_root
    move_tail = actor._move_tail

    def timed_search(params, t):
        before = program.search_counts(t) if window.open else None
        with rec.span("search"):
            out = run_sims(params, t)
        st["searches"] += 1
        if window.open:
            st["sims"] += per_game * B
            st["moves"] += 1
            window.count("moves")
            window.count("waves", per_game // wl["wave"])
            search_log.append((*before, *program.search_counts(out),
                               program.search_leftovers(out), per_game))
            if window.due():
                window.close()
                raise Stop
        elif st["searches"] == wl["warm_moves"]:
            window.start()
        return out

    def timed_prepare(params, t):
        with rec.span("prepare_root"):
            return prepare_root(params, t)

    def timed_tail(t, states, actions, active):
        keep = window.open
        if keep:
            legal = t.root_legal.clone()
        with rec.span("move_tail"):
            out = move_tail(t, states, actions, active)
        if keep:
            moves.append((out[2][1], actions.clone(), out[1].clone(), legal,
                          out[2][0], np.array(active)))
        return out

    mcts.run_sims = timed_search
    mcts.prepare_root = timed_prepare
    actor._move_tail = timed_tail
    with kernels.installed():
        try:
            actor.run(variables, seed=ctx.seed, log=lambda *a, **k: None)
        except Stop:
            pass
        else:
            raise RuntimeError("self-play ended before the window closed")
    wall = window.wall
    extras = {"roofline_least_s": kernels.least,
              "flops_per_row": c["forward_flops_per_row"]}
    holder = {"actor": actor, "nw": nw, "variables": variables}

    n = c["board_size"]

    def ref_weights():
        return net.to_torch(net.leaves(tree, c["blocks"]), ctx.device)

    def check():
        fields, pol, val, logit = tap.host_samples()
        net_nums = checks.network(fields, pol, val, logit, ref_weights(), n,
                                  ctx.device)
        host_moves = [(before, a.cpu().numpy(), after.to_numpy(),
                       legal.cpu().numpy(), visits, active)
                      for before, a, after, legal, visits, active in moves]
        rng = np.random.default_rng([ctx.seed, 2])
        checked, wrong = checks.engine(host_moves, n, rng)
        searches, bad = checks.search(search_log)
        replayed, tree_wrong = checks.tree(kernels.host_samples(),
                                           wl["recycle"])
        lim = wl["limits"]
        return [Check(k, net_nums[k], lim[k]) for k in net_nums
                if k in lim] + [
                Check("value_sign_wrong", net_nums["value_sign_wrong"], 0),
                Check("engine_wrong", wrong, 0),
                Check("engine_checked_short", int(checked < B), 0),
                Check("search_wrong", bad, 0),
                Check("searches_short", int(searches < 1), 0),
                Check("tree_wrong", tree_wrong, 0),
                Check("tree_replayed_short", int(replayed < 1), 0)]

    def control():
        fields, _, _, _ = tap.host_samples()
        return checks.network(fields, None, None, None, ref_weights(), n,
                              ctx.device, quant="fp8")

    return Outcome(end_to_end={"selfplay_sims_per_s": st["sims"] / wall},
                   attempted=st["moves"] * B, extras=extras, check=check,
                   release=holder.clear, control=control)
