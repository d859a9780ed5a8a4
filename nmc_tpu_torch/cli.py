"""Command-line entry point of the port: the `nmc` subcommand.

    python -m nmc_tpu_torch nmc --J J.npy --h h.npy --coloring --chains 256
    python -m nmc_tpu_torch nmc --instance path.txt --format chimera --coloring

Same flags and the same JSON output keys as ``python -m nmc_tpu nmc``. It
runs on the first CUDA card when there is one, else on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_problem(args):
    from .core.problem import IsingProblem
    from .io import loaders

    if args.instance:
        fn = {"wishart": loaders.load_wishart, "dcl": loaders.load_dcl,
              "chimera": loaders.load_chimera,
              "tree": loaders.load_contrived_tree}[args.format]
        return fn(args.instance)
    if args.J:
        J = np.load(args.J)
        h = np.load(args.h) if args.h else np.zeros(J.shape[0])
        return IsingProblem(J, h)
    raise SystemExit("provide --instance or --J/--h")


def _add_problem_args(p):
    p.add_argument("--instance", help="edge-list instance file")
    p.add_argument("--format", default="wishart",
                   choices=["wishart", "dcl", "chimera", "tree"])
    p.add_argument("--J", help="J.npy (dense matrix)")
    p.add_argument("--h", help="h.npy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", help="JSONL metrics output path")
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--coloring", action="store_true",
                   help="graph-colored blocks (sparse topologies)")


def cmd_nmc(args):
    import torch

    from .device import default_device
    from .models.nmc import NMCConfig, nmc_run
    from .utils.metrics import MetricsLogger

    prob = _load_problem(args)
    cfg = NMCConfig(
        num_sweeps_initial=args.sweeps_initial,
        num_sweeps_per_NMC_phase=args.sweeps_per_phase,
        num_NMC_cycles=args.cycles, global_beta=args.beta,
        temp_x=args.temp_x, lambda_start=args.lambda_start,
        num_chains=args.chains, block_size=args.block_size,
        use_coloring=args.coloring, record_m=False,
        tolerance=args.lbp_tolerance, max_iterations=args.lbp_iters,
    )
    device = default_device()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    metrics = MetricsLogger(path=args.metrics, echo=bool(args.metrics))
    res = nmc_run(prob, cfg, generator, metrics=metrics, device=device)
    out = {"min_energy": float(res.min_energy.min()),
           "min_energy_unnormalized": float(res.min_energy.min()
                                            * res.norm_factor),
           "num_chains": cfg.num_chains}
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nmc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nmc", help="single/multi-chain NMC solve")
    _add_problem_args(p)
    p.add_argument("--sweeps-initial", type=int, default=10_000)
    p.add_argument("--sweeps-per-phase", type=int, default=10_000)
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--beta", type=float, default=2.5)
    p.add_argument("--temp-x", type=float, default=20.0)
    p.add_argument("--lambda-start", type=float, default=3.0)
    p.add_argument("--lbp-tolerance", type=float, default=1e-8)
    p.add_argument("--lbp-iters", type=int, default=200)
    p.add_argument("--chains", type=int, default=1)
    p.set_defaults(fn=cmd_nmc)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
