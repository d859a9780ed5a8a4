"""Solution-quality campaign over a benchmark family's shipped ground truths.

The counterpart of ``nmc_tpu/campaign.py`` for its `pt`, `nmc`, `icm`,
`hybrid` and `icm_host` arms. The batched arms run ALL pending instances
of a family as one ensemble (`EnsembleNMC` for pt / nmc, `EnsembleICM` for
icm and the ICM+NMC hybrid), each instance's best state is checked against
its shipped ground-state energy between chunks of rounds, and one capped
run per instance gives its hit or miss at every budget up to the cap
(time-to-solution). `icm_host` runs `apt_icm_run` instance after instance.

Resumable: results stream to a JSONL file (same keys and format as the JAX
campaign's); instances already present are skipped. Hits are appended the
moment they are found, and a `.partial` snapshot of every instance's record
is replaced after each chunk.

    python -m nmc_tpu_torch campaign --kind chimera --folder DIR --arm nmc
    python -m nmc_tpu_torch campaign --family chimera512 --arm icm --device cuda

`--family` names resolve under the reference checkout, `$NMC_REFERENCE`
(default `reference` in the working directory). Not ported yet, and
refused with NotImplementedError: the `spectral` arm, `--init
spectral|file`, `--presolve`, `--refine`, `--summarize`, `--collect-best`
and the contrived family.
"""

import argparse
import json
import os
import time

import numpy as np

from .cli import add_device_arg, resolve_cli_device

REFERENCE_ROOT = os.environ.get("NMC_REFERENCE", "reference")


def _ref(subdir):
    return os.path.join(REFERENCE_ROOT, subdir)


_CHIMERA = "NMC/examples/Chimera_droplet_instances/"
_WISHART = "NPT/examples/wishart_small/"
_CONTRIVED = ("NMC/examples/contrived_wishart_backbone/"
              "wishart_contrived_trees/")

FAMILIES = {
    "chimera128": dict(
        kind="chimera", folder=_ref(_CHIMERA + "chimera128_spinglass_power"),
        coloring=True),
    "chimera512": dict(
        kind="chimera", folder=_ref(_CHIMERA + "chimera512_spinglass_power"),
        coloring=True),
    "chimera1152": dict(
        kind="chimera", folder=_ref(_CHIMERA + "chimera1152_spinglass_power"),
        coloring=True),
    "chimera2048": dict(
        kind="chimera", folder=_ref(_CHIMERA + "chimera2048_spinglass_power"),
        coloring=True),
    "dcl8": dict(kind="dcl", folder=_ref("NMC/examples/DCL_instances/C8"),
                 coloring=True),
    "dcl16": dict(kind="dcl", folder=_ref("NMC/examples/DCL_instances/C16"),
                  coloring=True),
    "wishart_n32_a0.50": dict(
        kind="wishart",
        folder=_ref(_WISHART + "wishart_planting_N_32_alpha_0.50"),
        coloring=False),
    "wishart_n40_a0.50": dict(
        kind="wishart",
        folder=_ref(_WISHART + "wishart_planting_N_40_alpha_0.50"),
        coloring=False),
    "wishart_n40_a0.30": dict(
        kind="wishart",
        folder=_ref(_WISHART + "wishart_planting_N_40_alpha_0.30"),
        coloring=False),
    "wishart_n40_a0.70": dict(
        kind="wishart",
        folder=_ref(_WISHART + "wishart_planting_N_40_alpha_0.70"),
        coloring=False),
    "contrived_n20_a0.20": dict(
        kind="contrived",
        folder=_ref(_CONTRIVED
                    + "wishart_planting_N_20_alpha_0.20_contrived_tree"),
        coloring=False),
    "contrived_n50_a0.20": dict(
        kind="contrived",
        folder=_ref(_CONTRIVED
                    + "wishart_planting_N_50_alpha_0.20_contrived_tree"),
        coloring=False),
}


def _later(what, item):
    return NotImplementedError(
        f"{what} is not ported to nmc_tpu_torch yet (ROADMAP.md, open items "
        f"queue 1: {item}); run it with python -m nmc_tpu campaign")


_REST = "the campaign's remaining arms and flags"


def get_instances(spec, limit):
    from . import evaluation as ev
    if spec["kind"] == "contrived":
        raise _later("the contrived family (best-known targets)", _REST)
    it = {"chimera": ev.chimera_folder_instances,
          "dcl": ev.dcl_folder_instances,
          "wishart": ev.wishart_folder_instances}[spec["kind"]]
    return it(spec["folder"], limit=limit)


def _num(x):
    """float or None: keeps the JSONL strict JSON (no NaN/Infinity)."""
    if x is None:
        return None
    x = float(x)
    return x if x == x and abs(x) != float("inf") else None


def build_ladder(beta_min, beta_max, num_replicas):
    """Geometric warm half + geometric cold half (denser near beta_max)."""
    half = num_replicas // 2
    warm = np.geomspace(beta_min, 3.0, half, endpoint=False)
    cold = np.geomspace(3.0, beta_max, num_replicas - half)
    return np.concatenate([warm, cold])


def build_apt_ladder(prob, beta_min, beta_max, seed=0, use_coloring=True,
                     device=None):
    """The APT preprocessor's sigma_E-adaptive schedule, built once on a
    representative instance of the family, padded to a multiple of 8 rungs
    by splitting the largest log-beta gaps, as the JAX campaign does."""
    import torch

    from .models.apt import APTConfig, apt_preprocess
    from .device import resolve_device
    device = resolve_device(device)
    cfg = APTConfig(num_sweeps_MCMC=1000, num_sweeps_read=1000, num_rng=100,
                    beta_start=beta_min, alpha=1.25, sigma_E_val=1000.0,
                    beta_max=beta_max, use_coloring=use_coloring)
    res = apt_preprocess(prob, cfg,
                         torch.Generator(device=device).manual_seed(seed),
                         device=device)
    beta = np.sort(np.asarray(res.beta))
    while beta.shape[0] % 8:
        g = np.argmax(np.diff(np.log(beta)))
        mid = np.sqrt(beta[g] * beta[g + 1])
        beta = np.sort(np.append(beta, mid))
    return beta


def _record(name, n, gs_norm, found, factor, hit_at, rounds_done,
            total_rounds, sweeps_per_round, wall, meta):
    hit = name in hit_at
    return dict(
        name=name, n=n, gs_raw=_num(gs_norm * factor),
        found_raw=_num(found * factor),
        residual=_num((found - gs_norm) * factor), hit=hit,
        hit_seconds=hit_at[name][1] if hit else None,
        hit_sweeps=hit_at[name][0] * sweeps_per_round if hit else None,
        rounds_completed=rounds_done, rounds_total=total_rounds,
        per_swap=sweeps_per_round, wall_seconds=wall, meta=meta)


def solve_ensemble_batch(pending, args, spec, meta, out_path):
    """ALL pending instances of a family solved as one ensemble
    (`EnsembleNMC` for pt / nmc, `EnsembleICM` for icm / hybrid): the
    per-instance ground-state targets are checked between chunks of
    rounds; an instance's time to solution is the shared wall clock at its
    first verified hit. Streams one JSONL record per instance."""
    import torch

    from .parallel.ensemble_nmc import EnsembleNMC, _pad_problem
    from .parallel.sharded_pt import ShardedNPTConfig

    device = resolve_cli_device(args.device)
    names = [name for name, _, _ in pending]
    orig_n = [prob.n for _, prob, _ in pending]
    # pad to the family max BEFORE normalization so the host-side f64
    # verification sees the engine's shapes (padded spins are free)
    n_max = max(prob.n for _, prob, _ in pending)
    probs, factors, gs_norm, atol_norm = [], [], [], []
    for _, prob, gs_raw in pending:
        if prob.n != n_max:
            prob = _pad_problem(prob, n_max)
        np_, f = prob.normalized()
        probs.append(np_)
        factors.append(f)
        gs_norm.append(gs_raw / f)
        atol_norm.append(max(1e-6 * abs(gs_raw), 1e-9) / f)
    I = len(probs)

    if args.ladder == "apt":
        beta = build_apt_ladder(pending[0][1], args.beta_min, args.beta_max,
                                seed=args.seed,
                                use_coloring=spec["coloring"], device=device)
        print(f"APT ladder: {len(beta)} rungs, "
              f"beta {beta[0]:.3g}..{beta[-1]:.3g}", flush=True)
    else:
        beta = build_ladder(args.beta_min, args.beta_max, args.replicas)
    num_replicas = len(beta)
    sweeps_per_round = args.num_cycles * 3 * args.sweeps_per_phase
    if args.arm in ("icm", "hybrid"):
        from .parallel.ensemble_icm import EnsembleICM, EnsembleICMConfig
        cfg = EnsembleICMConfig(
            sweeps_per_round=sweeps_per_round,
            num_subreplicas=args.subreplicas,
            num_swapping_pairs=max(num_replicas // 4, 1),
            use_coloring=spec["coloring"],
            # the hybrid: heated phases on the disagreement sets of the
            # --nmc-cold coldest rungs' paired chains
            hybrid_cold=args.nmc_cold if args.arm == "hybrid" else 0,
            temp_x=args.temp_x, num_cycles=args.num_cycles,
            houdayer=args.houdayer,
        )
        ens = EnsembleICM(probs, beta, cfg, device=device)
        what = (f"{num_replicas} replicas x {args.subreplicas} "
                f"sub-replicas, houdayer={ens.houdayer}")
    else:
        cold = args.nmc_cold if args.arm == "nmc" else 0
        if cold and args.nmc_placement == "near-global":
            # NMC replicas sample at global_beta whatever their label:
            # attach them to the rungs closest to global_beta, so the cold
            # end keeps plain cold sampling and the swap test stays nearly
            # consistent
            order = np.argsort(np.abs(np.log(beta / args.global_beta)))
            doNMC = np.zeros(num_replicas, bool)
            doNMC[order[:cold]] = True
            doNMC = doNMC.tolist()
        else:
            doNMC = [False] * (num_replicas - cold) + [True] * cold
        cfg = ShardedNPTConfig(
            sweeps_per_phase=args.sweeps_per_phase,
            num_cycles=args.num_cycles,
            num_swapping_pairs=max(num_replicas // 4, 1),
            global_beta=args.global_beta, temp_x=args.temp_x,
            threshold_initial=args.threshold_initial,
            threshold_cutoff=args.threshold_cutoff,
            use_coloring=spec["coloring"], lbp_mode="auto",
            lbp_every=args.lbp_every,
        )
        ens = EnsembleNMC(probs, beta, doNMC, cfg, device=device)
        what = f"{num_replicas} replicas"
    print(f"engine: {I} instances x {what}, n_pad {ens.n_pad}, "
          f"round_path={ens.round_path}, device={device}", flush=True)
    total_rounds = max(args.sweeps // sweeps_per_round, 1)

    t0 = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = ens.init_state(generator)
    rounds_done = 0
    hit_at = {}           # name -> (rounds, seconds)
    streamed = set()      # names whose FINAL row is already on disk
    save_dir = getattr(args, "save_best_states", None)
    saved64 = np.full(I, np.inf)   # energy at the last checkpointed state
    best64 = np.full(I, np.inf)
    best_m = [None] * I   # normalized padded state at best64 (f64)
    trace_path = out_path + ".trace" if getattr(args, "trace", False) else None
    while rounds_done < total_rounds and len(hit_at) < I:
        k = min(args.chunk_rounds, total_rounds - rounds_done)
        state = ens.run_scanned(state, k)
        rounds_done += k
        eb, mb = ens.best(state)
        now = time.perf_counter() - t0
        for i in range(I):
            if names[i] in hit_at:
                continue
            e_i = float(probs[i].energy(mb[i]))
            if e_i < best64[i]:
                best64[i] = e_i
                best_m[i] = np.asarray(mb[i], np.float64)
            if best64[i] <= gs_norm[i] + atol_norm[i]:
                hit_at[names[i]] = (rounds_done, now)
                print(f"  hit {names[i]} at round {rounds_done} "
                      f"({now:.1f}s)", flush=True)
                # stream the hit to the final file at discovery: a killed
                # batch keeps its hits and a relaunch skips them
                with open(out_path, "a") as f:
                    f.write(json.dumps(_record(
                        names[i], orig_n[i], gs_norm[i], best64[i],
                        factors[i], hit_at, rounds_done, total_rounds,
                        sweeps_per_round, now,
                        dict(meta, mode="ensemble", batch=I,
                             streamed_hit=True))) + "\n")
                streamed.add(names[i])
        if trace_path:
            # per-chunk residual curve (raw units)
            with open(trace_path, "a") as f:
                f.write(json.dumps(dict(
                    rounds=rounds_done,
                    sweeps=rounds_done * sweeps_per_round,
                    seconds=now, hits=len(hit_at),
                    residual_raw=[
                        _num((best64[i] - gs_norm[i]) * factors[i])
                        for i in range(I)],
                )) + "\n")
        # a full per-instance snapshot, atomically replaced each chunk
        tmp = out_path + ".partial.tmp"
        with open(tmp, "w") as f:
            for i, name in enumerate(names):
                f.write(json.dumps(_record(
                    name, orig_n[i], gs_norm[i], best64[i], factors[i],
                    hit_at, rounds_done, total_rounds, sweeps_per_round, now,
                    dict(meta, mode="ensemble", batch=I,
                         partial=True))) + "\n")
        os.replace(tmp, out_path + ".partial")
        if save_dir:
            # best-state checkpoint: unpadded +-1 state per instance,
            # atomically replaced whenever its best energy improves
            os.makedirs(save_dir, exist_ok=True)
            for i in range(I):
                if best_m[i] is None or best64[i] >= saved64[i]:
                    continue
                saved64[i] = best64[i]
                st = np.where(best_m[i][:orig_n[i]] >= 0, 1.0, -1.0)
                tmp_s = os.path.join(save_dir, names[i] + ".tmp")
                np.savetxt(tmp_s, st.astype(np.int8), fmt="%d")
                os.replace(tmp_s, os.path.join(save_dir, names[i]))
    wall = time.perf_counter() - t0

    results = []
    for i, name in enumerate(names):
        rec = _record(name, orig_n[i], gs_norm[i], best64[i], factors[i],
                      hit_at, rounds_done, total_rounds, sweeps_per_round,
                      wall, dict(meta, mode="ensemble", batch=I))
        if name not in streamed:   # hit rows were appended at discovery
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        res_str = ("n/a" if rec["residual"] is None
                   else f"{rec['residual']:.4f}")
        print(f"{name}: hit={rec['hit']} residual={res_str} "
              f"rounds={rounds_done}/{total_rounds}", flush=True)
        state_i = (None if best_m[i] is None else
                   np.where(best_m[i][:orig_n[i]] >= 0, 1.0, -1.0))
        results.append(dict(rec, state=state_i))
    if os.path.exists(out_path + ".partial"):
        os.remove(out_path + ".partial")   # superseded by the final records
    return results


def run_arm(args):
    if getattr(args, "folder", None):
        spec = dict(kind=args.kind, folder=args.folder,
                    coloring=args.kind in ("chimera", "dcl"))
    else:
        spec = dict(FAMILIES[args.family])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["name"])
                except (ValueError, KeyError):
                    pass

    meta = dict(family=args.family, arm=args.arm, replicas=args.replicas,
                ladder=args.ladder,
                beta_min=args.beta_min, beta_max=args.beta_max,
                sweeps=args.sweeps, swap_attempts=args.swap_attempts,
                sweeps_per_phase=args.sweeps_per_phase,
                chunk_rounds=args.chunk_rounds,
                nmc_cold=args.nmc_cold, global_beta=args.global_beta,
                nmc_placement=args.nmc_placement,
                lbp_every=args.lbp_every,
                num_cycles=args.num_cycles, temp_x=args.temp_x,
                threshold_initial=args.threshold_initial,
                threshold_cutoff=args.threshold_cutoff,
                seed=args.seed)
    print(f"# campaign {meta}", flush=True)

    if args.arm == "icm_host":
        solve_icm_host(args, spec, meta, done)
        return
    only = set(args.only.split(",")) if getattr(args, "only", None) else None
    pending = [(name, prob, gs) for name, prob, gs
               in get_instances(spec, args.instances)
               if name not in done and (only is None or name in only)]
    if not pending:
        print("all instances done", flush=True)
        return
    print(f"batched ensemble solve: {len(pending)} instances", flush=True)
    solve_ensemble_batch(pending, args, spec, meta, args.out)


def solve_icm_host(args, spec, meta, done):
    """The icm_host arm: `apt_icm_run` instance after instance (normalized,
    the ground-state target checked every round), one JSONL record each.
    The ladder is built from the first pending instance (`--ladder apt`
    honoured)."""
    import torch

    from .models.apt_icm import APTICMConfig, apt_icm_run

    device = resolve_cli_device(args.device)
    beta = None
    for name, prob, gs_raw in get_instances(spec, args.instances):
        if name in done:
            print(f"skip {name} (done)", flush=True)
            continue
        if beta is None:
            if args.ladder == "apt":
                beta = build_apt_ladder(prob, args.beta_min, args.beta_max,
                                        seed=args.seed,
                                        use_coloring=spec["coloring"],
                                        device=device)
                print(f"APT ladder: {len(beta)} rungs, "
                      f"beta {beta[0]:.3g}..{beta[-1]:.3g}", flush=True)
            else:
                beta = build_ladder(args.beta_min, args.beta_max,
                                    args.replicas)
        norm_factor = float(np.max(np.abs(prob.J))) or 1.0
        gs_norm = gs_raw / norm_factor
        atol_norm = max(1e-6 * abs(gs_raw), 1e-9) / norm_factor
        cfg = APTICMConfig(
            num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps,
            num_swap_attempts=args.swap_attempts,
            num_swapping_pairs=max(len(beta) // 4, 1),
            num_subreplicas=args.subreplicas,
            use_coloring=spec["coloring"], normalize=True,
            device_icm=args.device_icm,
            target_energy=gs_norm, target_atol=atol_norm,
        )
        t0 = time.perf_counter()
        res = apt_icm_run(prob, beta, cfg,
                          torch.Generator(device=device).manual_seed(
                              args.seed), device=device)
        wall = time.perf_counter() - t0
        per_swap = args.sweeps // args.swap_attempts
        rec = dict(
            name=name, n=prob.n, gs_raw=_num(gs_raw),
            found_raw=_num(res.min_energy * norm_factor),
            residual=_num(res.min_energy * norm_factor - gs_raw),
            hit=bool(res.hit_round is not None),
            hit_seconds=res.hit_seconds,
            hit_sweeps=(res.hit_round + 1) * per_swap
            if res.hit_round is not None else None,
            rounds_completed=int(res.rounds_completed),
            rounds_total=args.swap_attempts, per_swap=per_swap,
            wall_seconds=wall, meta=meta,
        )
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res_str = ("n/a" if rec["residual"] is None
                   else f"{rec['residual']:.4f}")
        print(f"{name}: hit={rec['hit']} residual={res_str} "
              f"rounds={rec['rounds_completed']}/{args.swap_attempts} "
              f"wall={wall:.1f}s", flush=True)


def add_campaign_args(p):
    p.add_argument("--family", choices=sorted(FAMILIES))
    p.add_argument("--kind", choices=["chimera", "dcl", "wishart", "contrived"],
                   help="instance dialect for --folder")
    p.add_argument("--folder", help="custom instance folder (overrides --family)")
    p.add_argument("--arm",
                   choices=["pt", "nmc", "icm", "hybrid", "icm_host",
                            "spectral"],
                   help="pt, nmc, icm, hybrid and icm_host run here; "
                        "spectral is not ported yet")
    p.add_argument("--init", choices=["random", "spectral", "file"],
                   default="random",
                   help="chain initialization (random here; spectral and "
                        "file are not ported yet)")
    p.add_argument("--save-best-states", default=None, metavar="DIR",
                   help="checkpoint each instance's best state to DIR/<name> "
                        "every chunk it improves")
    p.add_argument("--init-states",
                   help="state-file directory for --init file")
    p.add_argument("--only",
                   help="comma-separated instance names: restrict the "
                        "batched arms to these")
    p.add_argument("--init-chains", type=int, default=4)
    p.add_argument("--init-top", type=int, default=0)
    p.add_argument("--init-subspace", type=int, default=0)
    p.add_argument("--spectral-polish", type=int, default=8)
    p.add_argument("--spectral-dm", type=int, default=0)
    p.add_argument("--spectral-dm-iters", type=int, default=500)
    p.add_argument("--presolve", action="store_true",
                   help="exact leaf-peeling reduction (not ported yet)")
    p.add_argument("--dm-dim", default="alpha")
    p.add_argument("--refine", choices=["tree"], default=None,
                   help="post-run refinement (not ported yet)")
    p.add_argument("--refine-ils", type=float, default=60.0)
    p.add_argument("--summarize", nargs="+", metavar="JSONL",
                   help="summary table of result files (not ported yet)")
    p.add_argument("--best-known", default=None,
                   help="JSON of instance-name -> raw target energy")
    p.add_argument("--collect-best", nargs="+", metavar="JSONL", default=None,
                   help="merge campaign JSONLs into a best-known JSON (not "
                        "ported yet)")
    p.add_argument("--instances", type=int, default=20)
    p.add_argument("--out", default=None)
    p.add_argument("--replicas", type=int, default=32)
    p.add_argument("--ladder", choices=["geometric", "apt"],
                   default="geometric",
                   help="beta schedule: fixed geometric or the reference's "
                        "sigma_E-adaptive APT preprocessor")
    p.add_argument("--beta-min", type=float, default=0.25)
    p.add_argument("--beta-max", type=float, default=32.0)
    p.add_argument("--sweeps", type=int, default=1_600_000)
    p.add_argument("--swap-attempts", type=int, default=100)
    p.add_argument("--sweeps-per-phase", type=int, default=64)
    p.add_argument("--chunk-rounds", type=int, default=50)
    p.add_argument("--lbp-every", type=int, default=8)
    p.add_argument("--nmc-cold", type=int, default=6)
    p.add_argument("--nmc-placement", choices=["coldest", "near-global"],
                   default="coldest")
    # the reference's NMC examples all use 1/0.366838*5 ~= 13.63
    p.add_argument("--global-beta", type=float, default=13.63)
    p.add_argument("--num-cycles", type=int, default=3)
    p.add_argument("--temp-x", type=float, default=20.0)
    # defaults match the reference's run() signature defaults
    p.add_argument("--threshold-initial", type=float, default=0.999999)
    p.add_argument("--threshold-cutoff", type=float, default=0.99999)
    p.add_argument("--subreplicas", type=int, default=10)
    p.add_argument("--houdayer", default="auto",
                   choices=["auto", "matmul", "blocked", "sparse"])
    p.add_argument("--device-icm", action="store_true", default=True)
    p.add_argument("--no-device-icm", dest="device_icm", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", action="store_true",
                   help="append per-chunk residual curves to <out>.trace")
    add_device_arg(p)


def _refuse_unported(args):
    if args.collect_best:
        raise _later("--collect-best", _REST)
    if args.summarize:
        raise _later("--summarize", _REST)
    if args.arm == "spectral":
        raise _later(f"the {args.arm} arm", _REST)
    if args.init != "random":
        raise _later(f"--init {args.init}", _REST)
    if args.presolve:
        raise _later("--presolve", _REST)
    if args.refine:
        raise _later(f"--refine {args.refine}", _REST)


def run_campaign(args):
    _refuse_unported(args)
    if not args.arm:
        raise SystemExit("provide --arm")
    if not args.family and not args.folder:
        raise SystemExit("provide --family or --folder + --kind")
    if args.folder and not args.kind:
        raise SystemExit("--folder requires --kind")
    if args.out is None:
        tag = args.family or os.path.basename(args.folder.rstrip("/"))
        args.out = f"results/campaign/{tag}_{args.arm}.jsonl"
    run_arm(args)


def main(argv=None):
    p = argparse.ArgumentParser()
    add_campaign_args(p)
    run_campaign(p.parse_args(argv))


if __name__ == "__main__":
    main()
