"""Quality guardrail: root-policy divergence of node recycling
(counterpart of `tools/quality_recycle.py`).

Compares normalized root visit distributions between a bounded recycled
pool (the pool tier) and an unbounded pool at the SAME sim budget, over
random midgame positions (`quality.random_midgame_states`).

    python -m tak_tpu_torch.tools.quality_recycle --sims 10000 --games 8 \\
        [--cpu]

The reference run defaults to the large-tree tier at K=128; the candidate
to the recycled 1280-node pool.  Runs on the CUDA device unless `--cpu`
is given.
"""

from __future__ import annotations

import argparse

from .quality import add_position_flags, print_tv, probe_setup, root_policies


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_position_flags(ap, sims=10_000, wave=16, games=8)
    ap.add_argument("--cand-wave", type=int, default=None,
                    help="candidate wave size (default: same as --wave)")
    ap.add_argument("--budget", type=int, default=1280)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--ref-k", type=int, default=128)
    ap.add_argument("--ref-backend", default="pallas_hbm")
    args = ap.parse_args(argv)

    engine, net, variables, states = probe_setup(args)
    p_ref = root_policies(
        engine, net, variables, states, args.sims, args.wave,
        k=args.ref_k, budget=args.sims * 2 + 2, recycle=False,
        backend=args.ref_backend,
    )
    cand_wave = args.cand_wave or args.wave
    p_rec = root_policies(
        engine, net, variables, states, args.sims, cand_wave,
        k=args.k, budget=args.budget, recycle=True, backend="pallas",
        chunk=512,
    )
    print(f"recycled pool {args.budget} K={args.k} wave {cand_wave} vs "
          f"{args.ref_backend} K={args.ref_k} wave {args.wave} @ "
          f"{args.sims} sims, {args.games} positions (ply {args.plies}):")
    print_tv(p_ref, p_rec)


if __name__ == "__main__":
    main()
