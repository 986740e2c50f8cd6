"""Quality probe: root-policy divergence of edge truncation K against
full width (counterpart of `tools/quality_k.py`).

Children of non-root nodes keep only the top-K priors (`mcts/tree.py`);
the reference stores all legal children.  This measures what that
truncation does to the search result: total-variation distance between
normalized root visit distributions at `K` and at a full-width run, over
random midgame positions, same seeds.  Both runs take the "xla" descent
path (K semantics do not depend on the path).

    python -m tak_tpu_torch.tools.quality_k --k 16 --ref-k 96 --sims 512 \\
        --games 16 [--cpu]

Runs on the CUDA device unless `--cpu` is given (the JAX script forces
the CPU).
"""

from __future__ import annotations

import argparse

from .quality import add_position_flags, print_tv, probe_setup, root_policies


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_position_flags(ap, sims=512, wave=32, games=16)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--ref-k", type=int, default=96)
    ap.add_argument("--topk", default="exact", help="topk impl for the K run")
    ap.add_argument("--ref-topk", default="exact")
    args = ap.parse_args(argv)

    engine, net, variables, states = probe_setup(args)
    p_ref = root_policies(engine, net, variables, states, args.sims,
                          args.wave, k=args.ref_k, backend="xla",
                          topk=args.ref_topk)
    p_k = root_policies(engine, net, variables, states, args.sims,
                        args.wave, k=args.k, backend="xla", topk=args.topk)
    print(f"K={args.k}/{args.topk} vs K={args.ref_k}/{args.ref_topk} "
          f"@ {args.sims} sims, wave {args.wave}, "
          f"{args.games} positions (ply {args.plies}):")
    print_tv(p_ref, p_k)


if __name__ == "__main__":
    main()
