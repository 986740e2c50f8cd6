"""Control for the recycle quality guardrail: TV between two searches
without recycling that differ only in K or wave size, at deep sim budgets
(counterpart of `tools/quality_control.py`).

If two such searches already diverge strongly at 10k sims with an
untrained net, root-policy TV is a chaotic metric at this depth and the
recycle guardrail must be judged against this noise floor, not against
zero.

    python -m tak_tpu_torch.tools.quality_control --sims 10000 --games 8 \\
        [--cpu]

Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse

from .quality import add_position_flags, print_tv, probe_setup, root_policies


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_position_flags(ap, sims=10_000, wave=16, games=8)
    ap.add_argument("--k-a", type=int, default=128)
    ap.add_argument("--k-b", type=int, default=128)
    ap.add_argument("--wave-b", type=int, default=None)
    args = ap.parse_args(argv)

    engine, net, variables, states = probe_setup(args)
    budget = args.sims * 2 + 2
    p_a = root_policies(engine, net, variables, states, args.sims,
                        args.wave, k=args.k_a, budget=budget,
                        recycle=False, backend="pallas_hbm")
    p_b = root_policies(engine, net, variables, states, args.sims,
                        args.wave_b or args.wave, k=args.k_b, budget=budget,
                        recycle=False, backend="pallas_hbm")
    print(f"control: hbm K={args.k_a} wave {args.wave} vs hbm K={args.k_b} "
          f"wave {args.wave_b or args.wave} @ {args.sims} sims, "
          f"{args.games} positions:")
    print_tv(p_a, p_b)


if __name__ == "__main__":
    main()
