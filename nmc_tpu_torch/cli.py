"""Command-line entry points of the port: `nmc`, `apt`, `npt`, `icm`,
`evaluate`, `sharded`, `campaign`, `solve`, `exact`, `beam`, `refine` and
`generate`.

    python -m nmc_tpu_torch nmc --J J.npy --h h.npy --coloring --chains 256
    python -m nmc_tpu_torch nmc --instance path.txt --format chimera --coloring
    python -m nmc_tpu_torch apt --J J.npy --coloring --out-dir Results/data
    python -m nmc_tpu_torch npt --J J.npy --coloring \
        --beta-list Results/data/beta_list_python.npy --nmc-coldest 2
    python -m nmc_tpu_torch icm --instance path.txt --format chimera --coloring
    python -m nmc_tpu_torch campaign --kind chimera --folder DIR --arm nmc
    python -m nmc_tpu_torch solve DIR/wishart_..._inst_1.txt
    python -m nmc_tpu_torch exact DIR/wishart_..._inst_1.txt --backend pallas
    python -m nmc_tpu_torch refine DIR/001.txt --state s.txt --kind chimera
    python -m nmc_tpu_torch beam DIR/001.txt --beam 16
    python -m nmc_tpu_torch evaluate --folder DIR --family chimera --coloring
    python -m nmc_tpu_torch generate --kind sk --n 1000 --out inst.txt
    torchrun --nproc-per-node 4 -m nmc_tpu_torch sharded --J J.npy --coloring

Same flags, JSON output keys and exit codes as ``python -m nmc_tpu``'s
subcommands of those names (`solve`, `exact` and `beam` with `--device` in
place of `--cpu`, `exact` of `--interpret`; `beam` runs JAX's `--device`
route on a card and its host routes with `--device cpu`). Every subcommand
but `generate` (host-only file writing) takes `--device` (default `cuda`):
without a card it fails unless `--device cpu` is given. `main` first
joins a `torch.distributed` process group when torchrun's or the
NMC_TPU_* launch variables are set (`parallel/distributed.py`); `sharded`
then splits its replica ladder over the ranks, each on its own card.
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
    add_device_arg(p)


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu only "
                        "when named)")


def resolve_cli_device(name: str):
    """The device `--device` names; `cuda` without a card raises."""
    import torch

    from .device import default_device
    return default_device() if name == "cuda" else torch.device(name)


def _device_and_generator(args):
    import torch

    device = resolve_cli_device(args.device)
    return device, torch.Generator(device=device).manual_seed(args.seed)


def _metrics(args):
    from .utils.metrics import MetricsLogger
    return MetricsLogger(path=args.metrics, echo=bool(args.metrics))


def cmd_nmc(args):
    from .models.nmc import NMCConfig, nmc_run

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
    device, generator = _device_and_generator(args)
    res = nmc_run(prob, cfg, generator, metrics=_metrics(args), device=device)
    out = {"min_energy": float(res.min_energy.min()),
           "min_energy_unnormalized": float(res.min_energy.min()
                                            * res.norm_factor),
           "num_chains": cfg.num_chains}
    print(json.dumps(out))


def cmd_apt(args):
    from .models.apt import APTConfig, apt_preprocess

    prob = _load_problem(args)
    cfg = APTConfig(
        num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps_read,
        num_rng=args.chains, beta_start=args.beta_start, alpha=args.alpha,
        beta_max=args.beta_max, save_dir=args.out_dir,
        block_size=args.block_size, use_coloring=args.coloring,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
    )
    device, generator = _device_and_generator(args)
    res = apt_preprocess(prob, cfg, generator, metrics=_metrics(args),
                         device=device)
    print(json.dumps({"num_rungs": len(res.beta),
                      "beta": [round(b, 6) for b in res.beta]}))


def cmd_npt(args):
    from .models.npt import NPTConfig, npt_run

    prob = _load_problem(args)
    beta_list = np.load(args.beta_list) if args.beta_list else \
        np.linspace(args.beta_start, args.beta_max, args.replicas)
    R = beta_list.shape[0]
    doNMC = [False] * (R - args.nmc_coldest) + [True] * args.nmc_coldest
    cfg = NPTConfig(
        num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps_read,
        num_swap_attempts=args.swap_attempts,
        num_swapping_pairs=max(round(args.swap_fraction * R), 1),
        num_cycles=args.cycles, global_beta=args.beta,
        temp_x=args.temp_x, lambda_start=args.lambda_start,
        block_size=args.block_size, use_coloring=args.coloring,
        record_last_round_m=False,
        tolerance=args.lbp_tolerance, max_iterations=args.lbp_iters,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    device, generator = _device_and_generator(args)
    res = npt_run(prob, beta_list, doNMC, cfg, generator,
                  metrics=_metrics(args), device=device)
    print(json.dumps({
        "Energy": [float(e) for e in res.Energy],
        "min_energy": res.min_energy,
        "min_energy_unnormalized": res.min_energy * res.norm_factor,
        "acceptance_rate": res.acceptance_rate,
    }))


def cmd_icm(args):
    from .models.apt_icm import APTICMConfig, apt_icm_run

    prob = _load_problem(args).normalized()[0]
    beta_list = np.load(args.beta_list) if args.beta_list else \
        np.linspace(args.beta_start, args.beta_max, args.replicas)
    cfg = APTICMConfig(
        num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps_read,
        num_swap_attempts=args.swap_attempts,
        num_subreplicas=args.subreplicas, block_size=args.block_size,
        use_coloring=args.coloring, device_icm=args.device_icm,
    )
    device, generator = _device_and_generator(args)
    res = apt_icm_run(prob, beta_list, cfg, generator,
                      metrics=_metrics(args), device=device)
    print(json.dumps({
        "Energy": [float(e) for e in res.Energy],
        "min_energy": res.min_energy,
        "icm_moves": res.icm_moves, "icm_flips": res.icm_flips,
    }))


def cmd_sharded(args):
    """Replica-sharded NPT over the process group (one card, or several
    cards or hosts through torchrun or the NMC_TPU_* launch variables,
    parallel/distributed.py); rank 0 prints the record. With `--metrics`
    every rank logs one `round_spans` record a chunk: its rank, the chunk's
    stage seconds and counters (`ShardedNPT.round`'s `timings`)."""
    import torch

    from .parallel import distributed
    from .parallel.sharded_pt import ShardedNPT, ShardedNPTConfig

    prob = _load_problem(args).normalized()[0]
    beta_list = np.load(args.beta_list) if args.beta_list else \
        np.geomspace(args.beta_start, args.beta_max, args.replicas)
    R = beta_list.shape[0]
    doNMC = [False] * (R - args.nmc_coldest) + [True] * args.nmc_coldest
    cfg = ShardedNPTConfig(
        sweeps_per_phase=args.sweeps_per_phase, num_cycles=args.cycles,
        num_swapping_pairs=max(R // 4, 1), global_beta=args.beta,
        temp_x=args.temp_x, use_coloring=args.coloring,
        block_size=args.block_size,
    )
    device = (distributed.rank_device() if args.device == "cuda"
              else torch.device(args.device))
    npt = ShardedNPT(prob, beta_list, doNMC, cfg,
                     group=distributed.global_group(), device=device)
    state = npt.init_state(
        torch.Generator(device=device).manual_seed(args.seed))
    log = _metrics(args) if args.metrics else None
    rounds_done = 0
    while rounds_done < args.rounds:
        k = min(args.chunk_rounds, args.rounds - rounds_done)
        timings = None if log is None else {}
        state, metrics = npt.run_scanned(state, k, timings=timings)
        rounds_done += k
        e_best, m_best = npt.best(state)
        if log is not None:
            log.log("round_spans", rank=distributed.rank(), **timings)
        if args.target_energy is not None and \
                float(prob.energy(m_best)) <= args.target_energy:
            break
    e_best, m_best = npt.best(state)
    if distributed.rank() == 0:
        print(json.dumps({
            "min_energy": float(prob.energy(m_best)),
            "rounds": rounds_done,
            "replicas": R, "devices": distributed.world_size(),
            "processes": distributed.world_size(),
            "last_chunk_swap_accepts": int(metrics.accepted.sum()),
        }))


def cmd_evaluate(args):
    from . import evaluation as ev

    device = resolve_cli_device(args.device)
    folder_fns = {"wishart": ev.wishart_folder_instances,
                  "chimera": ev.chimera_folder_instances,
                  "dcl": ev.dcl_folder_instances}
    instances = list(folder_fns[args.family](args.folder, limit=args.limit))
    solver = ev.make_pt_solver(
        num_replicas=args.replicas, beta_min=args.beta_start,
        beta_max=args.beta_max, sweeps=args.sweeps,
        swap_attempts=args.swap_attempts, block_size=args.block_size,
        use_coloring=args.coloring, nmc_coldest=args.nmc_coldest,
        key_seed=args.seed, device=device)
    report = ev.evaluate_solver(instances, solver, tolerance=args.tolerance)
    print(report.to_json())


def _detect_instance(path, kind, target):
    """(prob, target, kind, base): dialect inferred from sibling
    ground-truth files, target pulled through the evaluation generators
    so normalization bookkeeping matches the campaign's exactly."""
    import os

    from . import evaluation as ev
    from .io import loaders

    path = os.path.abspath(path)
    folder, base = os.path.split(path)
    if kind == "auto":
        if os.path.exists(os.path.join(folder, "gs_energies.txt")):
            kind = "wishart"
        elif os.path.exists(os.path.join(folder, "groundstates_otn2d.txt")):
            kind = "chimera"
        elif os.path.exists(path.replace(".txt", "_sol.txt")):
            kind = "dcl"
        else:
            kind = "wishart"
    prob = None
    if target is None:
        gens = {"wishart": ev.wishart_folder_instances,
                "chimera": ev.chimera_folder_instances,
                "dcl": ev.dcl_folder_instances,
                "contrived": ev.contrived_folder_instances}
        try:
            for nm, p_, gs in gens[kind](folder):
                if nm == base:
                    prob, target = p_, gs
                    break
        except (FileNotFoundError, OSError):
            pass
    if prob is None:
        fn = {"wishart": loaders.load_wishart, "dcl": loaders.load_dcl,
              "chimera": loaders.load_chimera,
              "contrived": loaders.load_contrived_tree}[kind]
        prob = fn(path)
    return prob, target, kind, base


def _strict(x):
    """Strict JSON: a non-finite float -> null."""
    return (None if x is None
            or (isinstance(x, float) and not np.isfinite(x)) else x)


def cmd_solve(args):
    """The staged portfolio (`portfolio_solve`) on one instance, its target
    from the sibling ground-truth files unless --target; exit 1 when a
    known target is missed."""
    from .portfolio import portfolio_solve

    device = resolve_cli_device(args.device)
    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                args.target)
    arm = args.arm
    if arm == "auto":
        # the JAX package's measured family preferences: ICM on chimera
        # droplets, the ICM+NMC hybrid on DCL, spectral-seeded ICM else
        arm = {"chimera": "icm", "dcl": "hybrid"}.get(kind, "icm")
    spectral = ("auto" if not (args.no_spectral or args.force_spectral)
                else bool(args.force_spectral))
    res = portfolio_solve(
        prob, target, name=base, arm=arm, sweeps=args.sweeps,
        seed=args.seed, presolve=not args.no_presolve,
        spectral=spectral, dm_starts=args.dm_starts,
        dm_iters=args.dm_iters, coloring=kind in ("chimera", "dcl"),
        device=device)
    rec = dict(
        name=res.name, n=res.n, kind=kind,
        energy_raw=_strict(res.energy_raw),
        target_raw=_strict(res.target_raw), hit=res.hit,
        wall_seconds=round(res.wall_seconds, 3),
        stages=[dict(stage=s.stage, energy_raw=_strict(s.energy_raw),
                     wall_seconds=round(s.wall_seconds, 3), hit=s.hit,
                     **s.detail) for s in res.stages])
    line = json.dumps(rec, default=lambda o: None)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, res.state, fmt="%+d")
    return 0 if (res.hit or res.target_raw is None
                 or not np.isfinite(res.target_raw)) else 1


def cmd_refine(args):
    """The induced-tree refinement: a family's remaining misses from the
    state pools (--family), or one instance from a --state file. Exit 1
    when a target is missed (a family: when nothing attempted hits)."""
    from .refine import refine_family, tree_refine_state

    # host code, but the port's device policy holds: without a card the
    # default --device cuda fails, as every subcommand does
    resolve_cli_device(args.device)
    if args.family:
        only = args.only.split(",") if args.only else None
        hits, total = refine_family(
            args.family, only=only,
            skip_covered=not args.include_covered,
            ils_seconds=args.ils_seconds,
            extra_random=args.extra_random,
            deadline=args.deadline, out=args.out)
        return 0 if total == 0 or hits else 1
    if args.path is None or args.state is None:
        args.parser.error("refine needs --family, or an instance path "
                          "and --state")
    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                args.target)
    s0 = np.sign(np.loadtxt(args.state).reshape(-1))
    e_raw, state, info = tree_refine_state(
        prob, s0, target_raw=target, ils_seconds=args.ils_seconds,
        extra_random=args.extra_random, deadline=args.deadline)
    rec = dict(name=base, kind=kind, energy_raw=e_raw,
               target_raw=target, **info)
    line = json.dumps(rec, default=lambda o: None)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, state, fmt="%+d")
    return 0 if info["hit"] in (True, None) else 1


def auto_exact_backend(prob, device) -> str:
    """The tier `exact --backend auto` takes: host (numpy) to n = 28; to
    n = 40 the fused kernels on a CUDA card and the torch tiles elsewhere,
    as the JAX command does; above 40 the tropical DP for a chimera layout,
    else the fused tier. On an H100 (`chip_smoke.py`'s exact_tiers phase)
    the fused tier beats the torch tiles at the command's default tiles at
    every n from 30 to 40 (3.5 s against 37.5 s at n = 40); with 8192 x
    65536 tiles the torch tiles are up to 0.07 s faster to n = 34 and
    slower from n = 38 (6.6 s at n = 40)."""
    if prob.n <= 28:
        return "host"
    if prob.n <= 40:
        return "pallas" if device.type == "cuda" else "device"
    # beyond the MITM tiers' reach a chimera layout is the only exact
    # route (tropical DP, host-side)
    from .exact_chimera import chimera_layout
    try:
        chimera_layout(np.asarray(prob.J))
        return "chimera"
    except ValueError:
        return "pallas"


def cmd_exact(args):
    """Exact ground state by meet-in-the-middle enumeration: host (numpy,
    n <= ~30), device (torch tiles), pallas (the fused table kernels
    K6/K7), chimera (tropical DP for chimera layouts above 40); `auto`
    picks one by `auto_exact_backend`."""
    import time

    from .exact import solve_exact_device, solve_exact_fused, solve_exact_host

    device = resolve_cli_device(args.device)
    prob, target, kind, base = _detect_instance(args.path, args.kind, None)
    backend = args.backend
    if backend == "auto":
        backend = auto_exact_backend(prob, device)
    t0 = time.perf_counter()
    if backend == "chimera":
        from .exact_chimera import solve_exact_chimera
        e, s = solve_exact_chimera(prob)
    elif backend == "host":
        e, s = solve_exact_host(prob)
    elif backend == "device":
        e, s = solve_exact_device(prob, block_a=args.block_a,
                                  block_b=args.block_b, device=device)
    else:
        e, s = solve_exact_fused(prob, block_a=args.block_a,
                                 block_b=args.block_b, planes=args.planes,
                                 device=device)
    wall = time.perf_counter() - t0
    rec = dict(name=base, n=prob.n, kind=kind, backend=backend,
               planes=(args.planes if backend == "pallas" else None),
               energy_raw=e, wall_seconds=round(wall, 3),
               shipped_target=target if (target is None
                                         or np.isfinite(target)) else None,
               matches_shipped=(None if target is None
                                or not np.isfinite(target)
                                else bool(abs(e - target)
                                          <= max(1e-6 * abs(target),
                                                 1e-9))))
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, s, fmt="%+d")
    return 0


def _beam_on_host(device) -> bool:
    """`beam` takes JAX's host routes only when the caller names the CPU."""
    return device.type == "cpu"


def cmd_beam(args):
    """Deterministic tropical beam contraction (+ exact strip refinement)
    for chimera-raster instances; DCL rasters are padded automatically.
    On a card the int32 beam DP runs there, and so does the strips'
    sub-solver (JAX's `--device` route); `--device cpu` runs JAX's host
    routes: the multi-orientation beam in numpy, then the strips."""
    import time

    from .beam_chimera import (pad_to_chimera_grid, refine_strips,
                               solve_chimera_pipeline)

    device = resolve_cli_device(args.device)
    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                None)
    solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
    t0 = time.perf_counter()
    if not _beam_on_host(device):
        from .beam_chimera_cuda import solve_beam_chimera_cuda
        e, s, info = solve_beam_chimera_cuda(solve_prob, rows=rows,
                                             cols=cols,
                                             beam=1 << args.beam,
                                             device=device)
        if args.refine:
            sub = (lambda sp, R, w: solve_beam_chimera_cuda(
                sp, rows=R, cols=w, beam=1 << max(4, args.beam - 1),
                device=device)[:2])
            e, s, moves = refine_strips(solve_prob, s, rows=rows,
                                        cols=cols,
                                        window=args.window or 8,
                                        sub_solver=sub)
            info = dict(info, strip_moves=moves)
    elif args.refine:
        e, s, info = solve_chimera_pipeline(
            solve_prob, rows=rows, cols=cols, beam=1 << args.beam,
            orientations=args.orientations, window=args.window)
    else:
        from .beam_chimera import solve_beam_chimera_multi
        e, s, info = solve_beam_chimera_multi(
            solve_prob, rows=rows, cols=cols, beam=1 << args.beam,
            orientations=args.orientations)
    wall = time.perf_counter() - t0
    e = float(prob.energy(np.asarray(s)[:n_orig]))
    tol = 1e-6 * max(1.0, abs(target)) if target is not None else None
    rec = dict(name=base, n=prob.n, kind=kind, rows=rows, cols=cols,
               beam=args.beam, energy_raw=e,
               exact=bool(info.get("exact", False)),
               strip_moves=info.get("strip_moves"),
               wall_seconds=round(wall, 3),
               shipped_target=target if (target is None
                                         or np.isfinite(target)) else None,
               reaches_shipped=(None if target is None
                                or not np.isfinite(target)
                                else bool(e <= target + tol)))
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, np.asarray(s)[:n_orig], fmt="%+d")
    return 0


def cmd_generate(args):
    from .io import generators, writers

    kind = args.kind
    if kind == "sk":
        prob = generators.random_sk(args.n, seed=args.seed)
        gs = None
    elif kind == "ea2d":
        prob = generators.ea_2d(args.L, seed=args.seed)
        gs = None
    elif kind == "ea3d":
        prob = generators.ea_3d(args.L, seed=args.seed)
        gs = None
    elif kind == "wishart":
        prob, t, gs = generators.wishart_planted(args.n, args.alpha,
                                                 seed=args.seed)
    elif kind == "contrived":
        prob, t, gs = generators.contrived_wishart_backbone(
            args.n, args.alpha, seed=args.seed)
    else:
        # contrived-ref: the reference-faithful pipeline
        # (contrived_instance_generator.py)
        prob = generators.contrived_wishart_backbone_reference(
            args.n, alpha=args.alpha, seed=args.seed)
        gs = None
    writers.save_edgelist(args.out, prob)
    print(json.dumps({"n": prob.n, "edges": prob.num_edges,
                      "gs_energy": gs, "out": args.out}))


def build_parser() -> argparse.ArgumentParser:
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

    p = sub.add_parser("apt", help="adaptive beta-schedule preprocessor")
    _add_problem_args(p)
    p.add_argument("--sweeps", type=int, default=1000)
    p.add_argument("--sweeps-read", type=int, default=1000)
    p.add_argument("--chains", type=int, default=100)
    p.add_argument("--beta-start", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=1.25)
    p.add_argument("--beta-max", type=float, default=30.0)
    p.add_argument("--out-dir", default="Results/data")
    p.add_argument("--checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_apt)

    p = sub.add_parser("npt", help="replica exchange with NMC replicas")
    _add_problem_args(p)
    p.add_argument("--beta-list", help="beta_list_python.npy from apt")
    p.add_argument("--replicas", type=int, default=16)
    p.add_argument("--beta-start", type=float, default=0.3)
    p.add_argument("--beta-max", type=float, default=5.0)
    p.add_argument("--nmc-coldest", type=int, default=5)
    p.add_argument("--sweeps", type=int, default=10_000)
    p.add_argument("--sweeps-read", type=int, default=100)
    p.add_argument("--swap-attempts", type=int, default=10)
    p.add_argument("--swap-fraction", type=float, default=0.3)
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--beta", type=float, default=1 / 0.366838 * 5,
                   help="global_beta for NMC replicas")
    p.add_argument("--temp-x", type=float, default=20.0)
    p.add_argument("--lambda-start", type=float, default=3.0)
    p.add_argument("--lbp-tolerance", type=float, default=1e-8)
    p.add_argument("--lbp-iters", type=int, default=200)
    p.add_argument("--checkpoint", help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_npt)

    p = sub.add_parser("icm", help="APT + Houdayer ICM baseline")
    _add_problem_args(p)
    p.add_argument("--beta-list")
    p.add_argument("--replicas", type=int, default=8)
    p.add_argument("--beta-start", type=float, default=0.3)
    p.add_argument("--beta-max", type=float, default=5.0)
    p.add_argument("--sweeps", type=int, default=10_000)
    p.add_argument("--sweeps-read", type=int, default=1000)
    p.add_argument("--swap-attempts", type=int, default=100)
    p.add_argument("--subreplicas", type=int, default=10)
    p.add_argument("--device-icm", action="store_true", default=None,
                   help="Houdayer moves on the device (default: above 2048 "
                        "spins)")
    p.set_defaults(fn=cmd_icm)

    p = sub.add_parser("evaluate",
                       help="ground-truth hit-rate over a benchmark folder")
    p.add_argument("--folder", required=True)
    p.add_argument("--family", default="wishart",
                   choices=["wishart", "chimera", "dcl"])
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--replicas", type=int, default=12)
    p.add_argument("--beta-start", type=float, default=0.3)
    p.add_argument("--beta-max", type=float, default=4.0)
    p.add_argument("--sweeps", type=int, default=2000)
    p.add_argument("--swap-attempts", type=int, default=20)
    p.add_argument("--nmc-coldest", type=int, default=0)
    p.add_argument("--tolerance", type=float, default=1e-6)
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--coloring", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("sharded",
                       help="replica-sharded NPT over a torch.distributed "
                            "group (multi-card / -host)")
    _add_problem_args(p)
    p.add_argument("--beta-list")
    p.add_argument("--replicas", type=int, default=32)
    p.add_argument("--beta-start", type=float, default=0.25)
    p.add_argument("--beta-max", type=float, default=16.0)
    p.add_argument("--beta", type=float, default=2.5,
                   help="global_beta for NMC replicas")
    p.add_argument("--temp-x", type=float, default=20.0)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--chunk-rounds", type=int, default=50)
    p.add_argument("--sweeps-per-phase", type=int, default=64)
    p.add_argument("--cycles", type=int, default=3)
    p.add_argument("--nmc-coldest", type=int, default=0)
    p.add_argument("--target-energy", type=float, default=None,
                   help="stop when the f64 best energy reaches this "
                        "(normalized units)")
    p.set_defaults(fn=cmd_sharded)

    p = sub.add_parser(
        "campaign",
        help="batched solution-quality campaign over a benchmark family "
             "(pt, nmc, icm, hybrid and icm_host arms; per-instance "
             "time-to-solution vs shipped ground truths)")
    from .campaign import add_campaign_args, run_campaign
    add_campaign_args(p)
    p.set_defaults(fn=run_campaign)

    p = sub.add_parser(
        "solve",
        help="one-command staged portfolio solve of a single instance "
             "(presolve -> spectral/difference-map -> seeded MCMC -> "
             "induced-tree refinement); ground-truth target detected from "
             "sibling files")
    p.add_argument("path", help="instance file (edge-list dialects)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "wishart", "chimera", "dcl",
                            "contrived"])
    p.add_argument("--target", type=float, default=None,
                   help="raw target energy (default: sibling gs files)")
    p.add_argument("--arm", default="auto",
                   choices=["auto", "icm", "nmc", "pt", "hybrid"],
                   help="MCMC arm (auto: chimera->icm, dcl->hybrid, else "
                        "icm)")
    p.add_argument("--sweeps", type=int, default=200_000,
                   help="MCMC budget (0 = no MCMC stage)")
    p.add_argument("--dm-starts", type=int, default=2048)
    p.add_argument("--dm-iters", type=int, default=3000)
    p.add_argument("--no-presolve", action="store_true")
    p.add_argument("--no-spectral", action="store_true",
                   help="skip the spectral stage (default: auto, dense "
                        "cores only)")
    p.add_argument("--force-spectral", action="store_true",
                   help="run the spectral stage even on sparse graphs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-state", help="write the best +-1 state here")
    p.add_argument("--out", help="append the JSON record here")
    add_device_arg(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser(
        "exact",
        help="EXACT ground state by meet-in-the-middle enumeration "
             "(n <= ~50 on one card) — independently verifies shipped "
             "ground truths")
    p.add_argument("path", help="instance file (edge-list dialects)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "wishart", "chimera", "dcl",
                            "contrived"])
    p.add_argument("--backend", default="auto",
                   choices=["auto", "host", "device", "pallas", "chimera"],
                   help="host: numpy; device: torch tiles; pallas: the "
                        "fused table kernels K6 (f32) / K7 (int8 digit "
                        "planes), the JAX package's Pallas tier; chimera: "
                        "tropical DP (auto: host <= 28, then pallas on a "
                        "CUDA card and device elsewhere to 40, then "
                        "chimera or pallas)")
    tile = ("the table tile of the device tier and of the pallas tier's "
            "plain versions (--device cpu); the pallas kernels on the card "
            "walk all of B in one thread per A row")
    p.add_argument("--block-a", type=int, default=512,
                   help=f"A rows of {tile}, and pad the A table to a "
                        "multiple of it")
    p.add_argument("--block-b", type=int, default=4096,
                   help=f"B columns of {tile} (it must divide the B table)")
    p.add_argument("--planes", default="auto",
                   choices=["auto", "on", "off"],
                   help="int8 digit-plane kernel K7 (pallas tier; "
                        "integer-coupled instances, bound < 2^29); off "
                        "forces the f32 kernel K6")
    p.add_argument("--save-state", help="write the ground state here")
    p.add_argument("--out", help="append the JSON record here")
    add_device_arg(p)
    p.set_defaults(fn=cmd_exact)

    p = sub.add_parser(
        "beam",
        help="deterministic tropical beam contraction for chimera-"
             "raster instances (C4..C16, DCL) + exact strip refinement")
    p.add_argument("path", help="instance file (edge-list dialects)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "wishart", "chimera", "dcl",
                            "contrived"])
    p.add_argument("--beam", type=int, default=16,
                   help="log2 of the beam width")
    p.add_argument("--orientations", type=int, default=1,
                   help="grid orientations of the host beam (--device cpu)")
    p.add_argument("--no-refine", dest="refine", action="store_false",
                   help="skip the strip-refinement stage")
    p.add_argument("--window", type=int, default=None,
                   help="refinement strip width in cells (default auto; 8 "
                        "on a card)")
    p.add_argument("--save-state", help="write the best state here")
    p.add_argument("--out", help="append the JSON record here")
    add_device_arg(p)
    p.set_defaults(fn=cmd_beam)

    p = sub.add_parser(
        "refine",
        help="deterministic induced-tree large-neighborhood descent (exact "
             "DP over maximal induced cell trees + 2x2-cell-block ILS "
             "kicks) over a family's remaining misses from the saved "
             "state pools, or one instance from --state")
    p.add_argument("path", nargs="?", default=None,
                   help="single instance file (omit with --family)")
    p.add_argument("--family", default=None,
                   help="grid family (chimera*/dcl*): refine every "
                        "not-yet-covered instance from the state pools")
    p.add_argument("--only", help="comma-separated instance names")
    p.add_argument("--include-covered", action="store_true",
                   help="also refine instances another tier already hit")
    p.add_argument("--state", help="+-1 state file seeding the single-"
                                   "instance descent")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "chimera", "dcl"])
    p.add_argument("--target", type=float, default=None,
                   help="raw target energy (default: sibling gs files)")
    p.add_argument("--ils-seconds", type=float, default=60.0)
    p.add_argument("--extra-random", type=int, default=24)
    p.add_argument("--deadline", type=float, default=None)
    p.add_argument("--save-state", help="write the refined +-1 state here")
    p.add_argument("--out", help="append JSONL rows here")
    add_device_arg(p)
    p.set_defaults(fn=cmd_refine, parser=p)

    p = sub.add_parser("generate", help="write benchmark instances")
    p.add_argument("--kind", required=True,
                   choices=["sk", "ea2d", "ea3d", "wishart", "contrived",
                            "contrived-ref"])
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--L", type=int, default=8)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_generate)
    return ap


def main(argv=None):
    # multi-process launch: joins the torch.distributed process group when
    # torchrun's or the NMC_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID
    # variables are set (a no-op otherwise), parallel/distributed.py
    from .parallel.distributed import initialize_from_env
    initialize_from_env()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
