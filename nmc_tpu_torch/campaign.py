"""Solution-quality campaign over a benchmark family's shipped ground truths.

The counterpart of ``nmc_tpu/campaign.py`` for its `pt`, `nmc`, `icm`,
`hybrid`, `icm_host` and `spectral` arms. The batched arms run ALL pending
instances of a family as one ensemble (`EnsembleNMC` for pt / nmc,
`EnsembleICM` for icm and the ICM+NMC hybrid), each instance's best state
is checked against its shipped ground-state energy between chunks of
rounds, and one capped run per instance gives its hit or miss at every
budget up to the cap (time-to-solution). `icm_host` runs `apt_icm_run` instance after instance.

Resumable: results stream to a JSONL file (same keys and format as the JAX
campaign's); instances already present are skipped. Hits are appended the
moment they are found, and a `.partial` snapshot of every instance's record
is replaced after each chunk.

    python -m nmc_tpu_torch campaign --kind chimera --folder DIR --arm nmc
    python -m nmc_tpu_torch campaign --family chimera512 --arm icm --device cuda

The `spectral` arm runs the host spectral search per instance (no MCMC).
`--presolve` peels the instances' leaves exactly (`ops/presolve.py`) and
every arm runs on the 2-cores, with records in original raw units;
`--init spectral|file` seeds the coldest chains from spectral candidates
or from state files; `--refine tree` runs the induced-tree refinement
(`refine.refine_family`) over a grid family's remaining misses afterwards.

The contrived family ships no exact ground truths: its targets come from
a best-known JSON (`--best-known`, default `best_known.json` in the
folder), which `--collect-best` builds from campaign JSONLs; without one
its records carry no target and every run takes the full budget.
`--summarize` prints a table of result files (hit rate, TTS and miss
residual quantiles).

`--family` names resolve under the reference checkout, `$NMC_REFERENCE`
(default `reference` in the working directory).
"""

import argparse
import dataclasses
import json
import os
import re
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


def get_instances(spec, limit):
    from . import evaluation as ev
    if spec["kind"] == "contrived":
        return ev.contrived_folder_instances(
            spec["folder"], limit=limit, best_known=spec.get("best_known"))
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


def _dm_dim(spec, name, n):
    """Resolve the --dm-dim knob to an int (or None = the spectral-gap
    estimate inside ops.spectral): 'alpha' parses `alpha_X.YZ` from the
    instance name (wishart folder convention) -> d = n - round(alpha*n)."""
    if spec == "auto":
        return None
    if spec == "alpha":
        m = re.search(r"alpha_(\d+\.?\d*)", name)
        if not m:
            return None
        return max(2, n - int(round(float(m.group(1)) * n)))
    return int(spec)


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


def _record(name, n, gs_norm, found, factor, const, hit_at, rounds_done,
            total_rounds, sweeps_per_round, wall, meta):
    """One JSONL record in original raw units: `const` is the energy the
    presolve folded out (0 without it); residuals do not change."""
    hit = name in hit_at
    return dict(
        name=name, n=n, gs_raw=_num(gs_norm * factor + const),
        found_raw=_num(found * factor + const),
        residual=_num((found - gs_norm) * factor), hit=hit,
        hit_seconds=hit_at[name][1] if hit else None,
        hit_sweeps=hit_at[name][0] * sweeps_per_round if hit else None,
        rounds_completed=rounds_done, rounds_total=total_rounds,
        per_swap=sweeps_per_round, wall_seconds=wall, meta=meta)


def _presolve_pending(pending):
    """Peel every instance to its 2-core (`ops/presolve.py`). Returns the
    pending list on the cores, with each target shifted by the folded
    constant, and each instance's `Presolve` (for back-substitution)."""
    from .core.problem import IsingProblem
    from .ops.presolve import peel_leaves
    reduced, pss = [], []
    for name, prob, gs_raw in pending:
        ps = peel_leaves(np.asarray(prob.J), np.asarray(prob.h))
        core = IsingProblem(ps.J_core, ps.h_core, name=name + ":core")
        pss.append(ps)
        reduced.append((name, core,
                        None if gs_raw is None else gs_raw - ps.constant))
    return reduced, pss


def _full_state(m, core_n, ps):
    """A normalized padded (core) state -> the +-1 state of the original
    instance: unpad to the core, then back-substitute the peeled leaves."""
    s_core = np.where(np.asarray(m)[:core_n] >= 0, 1.0, -1.0)
    return ps.back_substitute(s_core) if ps is not None else s_core


def _file_seeds(args, names, orig_n, n_max):
    """[I, C, n_max] seeds from --init-states DIR/<name> (one +-1 per line,
    original spin order), each repeated over the C coldest chains."""
    C = max(1, args.init_chains)
    seeds = []
    for k, nm in enumerate(names):
        st = np.sign(np.loadtxt(
            os.path.join(args.init_states, nm)).reshape(-1))
        if st.size != orig_n[k] or not np.all(np.abs(st) == 1.0):
            raise ValueError(f"seed state {nm}: expected "
                             f"{orig_n[k]} +-1 spins, got {st.size}")
        s = np.ones(n_max)
        s[:st.size] = st
        seeds.append(s)
    return C, np.repeat(np.asarray(seeds)[:, None, :], C, axis=1)


def solve_ensemble_batch(pending, args, spec, meta, out_path):
    """ALL pending instances of a family solved as one ensemble
    (`EnsembleNMC` for pt / nmc, `EnsembleICM` for icm / hybrid): the
    per-instance ground-state targets are checked between chunks of
    rounds; an instance's time to solution is the shared wall clock at its
    first verified hit. Streams one JSONL record per instance. With
    `--presolve` the engines run on the instances' 2-cores (peeled, then
    padded to the family max, then normalized, then the targets shifted by
    the folded constant); states map back by unpadding to the core and
    back-substituting."""
    import torch

    from .parallel.ensemble_nmc import EnsembleNMC, _pad_problem
    from .parallel.sharded_pt import ShardedNPTConfig

    device = resolve_cli_device(args.device)
    names = [name for name, _, _ in pending]
    orig_n = [prob.n for _, prob, _ in pending]
    consts = np.zeros(len(pending))
    pss = [None] * len(pending)    # Presolve per instance (back-substitution)
    if getattr(args, "presolve", False):
        pending, pss = _presolve_pending(pending)
        consts = np.array([ps.constant for ps in pss])
        meta = dict(meta, presolve="peel",
                    core_n=[p.n for _, p, _ in pending])
        print(f"presolve: peeled to cores "
              f"{min(p.n for _, p, _ in pending)}.."
              f"{max(p.n for _, p, _ in pending)} of n={max(orig_n)}",
              flush=True)
    # pad to the family max BEFORE normalization so the host-side f64
    # verification sees the engine's shapes (padded spins are free)
    core_n = [prob.n for _, prob, _ in pending]
    n_max = max(core_n)
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

    m0 = None
    if args.init == "spectral":
        # seed the coldest chains with spectral-descent candidates of the
        # normalized, padded problems (rounding and descent are
        # scale-invariant; padded spins come out +1)
        from .ops.spectral import spectral_candidates
        t_s = time.perf_counter()
        C = args.init_chains
        m0 = np.stack([
            spectral_candidates(p.J, p.h if np.any(p.h) else None,
                                top_k=args.init_top or None,
                                num_subspace=args.init_subspace,
                                dm_starts=args.spectral_dm,
                                dm_iters=args.spectral_dm_iters,
                                # an alpha-parsed d means nothing on a
                                # peeled, padded core: the gap estimate
                                dm_dim=(None if getattr(args, "presolve",
                                                        False)
                                        else _dm_dim(args.dm_dim,
                                                     names[k], p.n)),
                                seed=args.seed)[0][:C]
            for k, p in enumerate(probs)])
        meta = dict(meta, init="spectral", init_chains=C,
                    init_top=args.init_top,
                    init_subspace=args.init_subspace,
                    init_dm=args.spectral_dm)
        print(f"spectral seeding: {C} chains x {I} instances in "
              f"{time.perf_counter() - t_s:.1f}s", flush=True)
    elif args.init == "file":
        # seed the coldest chains from per-instance state files, so the
        # chains start inside an earlier run's basin
        if any(ps is not None for ps in pss):
            raise ValueError("--init file states are in the original "
                             "index space; incompatible with --presolve")
        C, m0 = _file_seeds(args, names, orig_n, n_max)
        meta = dict(meta, init="file", init_chains=C,
                    init_states=args.init_states)
        print(f"file seeding: {C} chains x {I} instances from "
              f"{args.init_states}", flush=True)

    t0 = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = ens.init_state(generator, m0=m0)
    rounds_done = 0
    hit_at = {}           # name -> (rounds, seconds)
    streamed = set()      # names whose FINAL row is already on disk
    save_dir = getattr(args, "save_best_states", None)
    saved64 = np.full(I, np.inf)   # energy at the last checkpointed state
    best64 = np.full(I, np.inf)
    best_m = [None] * I   # normalized padded (core) state at best64 (f64)
    trace_path = out_path + ".trace" if getattr(args, "trace", False) else None

    def record(i, now, **extra):
        return _record(names[i], orig_n[i], gs_norm[i], best64[i],
                       factors[i], consts[i], hit_at, rounds_done,
                       total_rounds, sweeps_per_round, now,
                       dict(meta, mode="ensemble", batch=I, **extra))

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
                    f.write(json.dumps(record(i, now, streamed_hit=True))
                            + "\n")
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
            for i in range(I):
                f.write(json.dumps(record(i, now, partial=True)) + "\n")
        os.replace(tmp, out_path + ".partial")
        if save_dir:
            # best-state checkpoint: the full-space +-1 state per instance
            # (unpadded, back-substituted), atomically replaced whenever its
            # best energy improves; the format --init file reads
            os.makedirs(save_dir, exist_ok=True)
            for i in range(I):
                if best_m[i] is None or best64[i] >= saved64[i]:
                    continue
                saved64[i] = best64[i]
                st = _full_state(best_m[i], core_n[i], pss[i])
                tmp_s = os.path.join(save_dir, names[i] + ".tmp")
                np.savetxt(tmp_s, st.astype(np.int8), fmt="%d")
                os.replace(tmp_s, os.path.join(save_dir, names[i]))
    wall = time.perf_counter() - t0

    results = []
    for i, name in enumerate(names):
        rec = record(i, wall)
        if name not in streamed:   # hit rows were appended at discovery
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        res_str = ("n/a" if rec["residual"] is None
                   else f"{rec['residual']:.4f}")
        print(f"{name}: hit={rec['hit']} residual={res_str} "
              f"rounds={rounds_done}/{total_rounds}", flush=True)
        state_i = (None if best_m[i] is None
                   else _full_state(best_m[i], core_n[i], pss[i]))
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
    if getattr(args, "best_known", None):
        spec["best_known"] = args.best_known
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

    if args.arm == "spectral":
        solve_spectral(args, spec, meta, done)
        return
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


def solve_spectral(args, spec, meta, done):
    """The spectral arm: the host spectral search (`ops/spectral.py`:
    eigh, sign rounding, batched 1-flip descent, the difference-map pool
    and the 2-flip polish) instance after instance, no MCMC; with
    `--presolve` on the 2-core, its energy shifted back to raw units."""
    from .ops.spectral import spectral_search
    meta = dict(meta, sweeps=0, init_top=args.init_top,
                init_subspace=args.init_subspace,
                polish=args.spectral_polish,
                dm=args.spectral_dm, dm_dim=args.dm_dim)
    for name, prob, gs_raw in get_instances(spec, args.instances):
        if name in done:
            continue
        t0 = time.perf_counter()
        ps = None
        if args.presolve:
            [(_, prob, _)], [ps] = _presolve_pending([(name, prob, None)])
        r = spectral_search(
            prob, top_k=args.init_top or None,
            num_subspace=args.init_subspace,
            dm_starts=args.spectral_dm,
            dm_iters=args.spectral_dm_iters,
            dm_dim=_dm_dim(args.dm_dim, name, prob.n),
            polish=args.spectral_polish, seed=args.seed)
        if ps is not None:
            # shift back to original raw units (exact reduction)
            r = dataclasses.replace(r, best_energy=r.best_energy + ps.constant)
        wall = time.perf_counter() - t0
        hit = (gs_raw is not None and not np.isnan(gs_raw)
               and r.best_energy <= gs_raw + max(1e-6 * abs(gs_raw), 1e-9))
        rec = dict(
            name=name, n=prob.n, gs_raw=_num(gs_raw),
            found_raw=_num(r.best_energy),
            residual=_num(r.best_energy - gs_raw)
            if gs_raw is not None else None,
            hit=bool(hit),
            hit_seconds=wall if hit else None, hit_sweeps=0,
            rounds_completed=1, rounds_total=1,
            per_swap=0, wall_seconds=wall, meta=meta,
        )
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res_str = ("n/a" if rec["residual"] is None
                   else f"{rec['residual']:.4f}")
        print(f"{name}: hit={rec['hit']} residual={res_str} "
              f"wall={wall:.2f}s", flush=True)


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
                            "spectral"])
    p.add_argument("--init", choices=["random", "spectral", "file"],
                   default="random",
                   help="chain initialization for the batched arms: "
                        "'spectral' seeds the --init-chains coldest chains "
                        "per instance with spectral-descent states "
                        "(ops/spectral.py); 'file' seeds them from "
                        "--init-states DIR/<instance-name>")
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
                   help="exact leaf-peeling reduction before any arm "
                        "(ops/presolve.py): tree-decorated instances run "
                        "on their 2-core; records stay in original raw "
                        "units")
    p.add_argument("--dm-dim", default="alpha",
                   help="difference-map subspace dimension: 'alpha' = "
                        "n - round(alpha*n) parsed from the instance name "
                        "(else the spectral-gap estimate), 'auto' = the "
                        "spectral-gap estimate, or an integer")
    p.add_argument("--refine", choices=["tree"], default=None,
                   help="after the arm, the induced-tree refinement of a "
                        "grid family's remaining misses from the saved "
                        "state pools (refine.refine_family)")
    p.add_argument("--refine-ils", type=float, default=60.0,
                   help="per-instance iterated-local-search budget (s) "
                        "for --refine tree")
    p.add_argument("--summarize", nargs="+", metavar="JSONL",
                   help="render a summary table from campaign result files "
                        "instead of running")
    p.add_argument("--best-known", default=None,
                   help="JSON file of instance-name -> raw target energy "
                        "(for families without shipped ground truths)")
    p.add_argument("--collect-best", nargs="+", metavar="JSONL", default=None,
                   help="merge campaign JSONLs into a best-known JSON "
                        "(written to --out) instead of running")
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


def collect_best(paths, out_path):
    """Merge campaign JSONLs into {name: best found_raw}: the best-known
    targets file that `contrived_folder_instances` reads."""
    best = {}
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            best = {k: float(v) for k, v in json.load(f).items()}
    for path in paths:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                e = r.get("found_raw")
                if e is None or e != e:
                    continue
                name = r["name"]
                if name not in best or e < best[name]:
                    best[name] = float(e)
    with open(out_path, "w") as f:
        json.dump(best, f, indent=1, sort_keys=True)
    print(f"wrote {len(best)} best-known targets to {out_path}")
    return best


def summarize(paths):
    """Render a per-(family, arm) summary table from campaign JSONL files:
    hit rate, TTS quantiles over hits, residual quantiles over misses."""
    from .utils.plotting import miss_residuals

    rows = []
    for path in paths:
        with open(path) as f:
            rs = [json.loads(line) for line in f]
        if not rs:
            continue
        meta = rs[0].get("meta", {})
        hits = [r for r in rs if r["hit"]]
        tts = sorted(r["hit_seconds"] for r in hits)
        miss = miss_residuals(rs)

        def q(xs, p):
            return xs[min(int(p * len(xs)), len(xs) - 1)] if xs else None

        rows.append(dict(
            run=os.path.splitext(os.path.basename(path))[0],
            family=meta.get("family", os.path.basename(path)),
            arm=meta.get("arm", "?"), n=rs[0]["n"], instances=len(rs),
            hits=len(hits),
            sweeps_budget=meta.get("sweeps"),
            wall=round(rs[0].get("wall_seconds", 0), 1),
            tts_p50=q(tts, 0.5), tts_p90=q(tts, 0.9),
            miss_res_p50=q(miss, 0.5), miss_res_max=q(miss, 1.0),
        ))
    fmt = ("| {run} | {arm} | {n} | {hits}/{instances} | "
           "{sweeps_budget} | {wall} | {tts_p50} | {tts_p90} | "
           "{miss_res_p50} | {miss_res_max} |")
    print("| run | arm | N | GS hits | sweep budget | wall (s) | "
          "TTS p50 (s) | TTS p90 (s) | miss residual p50 (%) | max (%) |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        r = {k: (round(v, 2) if isinstance(v, float) else v)
             for k, v in r.items()}
        print(fmt.format(**{k: ("—" if v is None else v)
                            for k, v in r.items()}))
    return rows


def run_campaign(args):
    if args.collect_best:
        if not args.out:
            raise SystemExit("--collect-best requires --out")
        collect_best(args.collect_best, args.out)
        return
    if args.summarize:
        summarize(args.summarize)
        return
    if not args.arm:
        raise SystemExit("provide --arm (or --summarize)")
    if not args.family and not args.folder:
        raise SystemExit("provide --family or --folder + --kind")
    if args.folder and not args.kind:
        raise SystemExit("--folder requires --kind")
    if args.out is None:
        tag = args.family or os.path.basename(args.folder.rstrip("/"))
        args.out = f"results/campaign/{tag}_{args.arm}.jsonl"
    run_arm(args)
    if args.refine == "tree":
        from .refine import grid_family_folders, refine_family
        if args.family not in grid_family_folders():
            print(f"--refine tree: {args.family or args.folder} is not a "
                  "grid family; skipping", flush=True)
            return
        only = args.only.split(",") if args.only else None
        refine_family(args.family, only=only, ils_seconds=args.refine_ils)


def main(argv=None):
    p = argparse.ArgumentParser()
    add_campaign_args(p)
    run_campaign(p.parse_args(argv))


if __name__ == "__main__":
    main()
