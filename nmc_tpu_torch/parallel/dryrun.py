"""Multi-rank dry run and a launcher of rank processes.

`dryrun_multirank(device)` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: on the current process group it runs
a ShardedNPT round, an EnsemblePT round, spin-sharded sweeps, the 2-D
replica x spin swap round (at W >= 4, W even), EnsembleNMC on the plain
and the kernel route and ShardedNPT on the kernel route, and checks each
result's shape, finiteness and label permutations.

`sharded_cases(device, payload)` runs every sharded engine at a small size
on the current group and returns its gathered results (numpy), one entry
per name of `SHARDED_CASES`; the same seed must give the same entries at
every world size, which the tests check over gloo on the CPU.

`launch_ranks(target, world)` runs a function on `world` fresh `python -c`
processes joined into one process group (through the NMC_TPU_* launch
variables of `distributed.initialize`, on a free local port) and returns
each rank's result. Fresh interpreters avoid `fork` after CUDA and the
re-import of a caller's main module; the kernels should be built before
(`ops/_build.build_all`), as a build is atomic but not shared.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import distributed

ROOT = Path(__file__).resolve().parents[2]

SHARDED_CASES = ("sharded_npt_kernel", "sharded_npt_k1", "sharded_npt_seq",
                 "spin", "spin_grid", "ensemble_nmc_kernel",
                 "ensemble_nmc_plain", "ensemble_icm_kernel",
                 "ensemble_icm_plain", "ensemble_pt")

_LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "NMC_TPU_COORDINATOR", "NMC_TPU_NUM_PROCESSES",
                "NMC_TPU_PROCESS_ID")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(target: str, world: int, *, backend: str = "gloo",
                 device: str = "cpu", payload=None, timeout: float = 300.0,
                 threads: int = 1) -> list:
    """Run `target` ("module:function", called as fn(device, payload)) on
    `world` ranks of one new process group (`backend`), each a fresh
    interpreter started in the repository root with `threads` CPU threads;
    returns the ranks' results in rank order. Raises with a rank's stderr
    when one fails, and kills every rank past `timeout` seconds."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        procs, logs = [], []
        for k in range(world):
            env = {key: v for key, v in os.environ.items()
                   if key not in _LAUNCH_VARS}
            env.update(NMC_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       NMC_TPU_NUM_PROCESSES=str(world),
                       NMC_TPU_PROCESS_ID=str(k),
                       OMP_NUM_THREADS=str(threads),
                       MKL_NUM_THREADS=str(threads))
            code = ("from nmc_tpu_torch.parallel.dryrun import _rank_main; "
                    f"_rank_main({target!r}, {backend!r}, {device!r}, "
                    f"{tmp!r}, {threads})")
            log = open(os.path.join(tmp, f"rank{k}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          cwd=ROOT, env=env,
                                          stdout=log, stderr=log))
        deadline = time.monotonic() + timeout
        try:
            for k, p in enumerate(procs):
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{target} on {world} ranks ran past "
                               f"{timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for k, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0:
                failed.append(f"rank {k} exited {p.returncode}:\n"
                              f"{text[-3000:]}")
        if failed:
            raise RuntimeError(f"{target} on {world} ranks:\n"
                               + "\n".join(failed))
        out = []
        for k in range(world):
            with open(os.path.join(tmp, f"rank{k}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(target, backend, device, tmp, threads):
    """A rank process of `launch_ranks`: join the group, run the target,
    write its result, leave the group."""
    import importlib
    import torch.distributed as dist
    torch.set_num_threads(threads)
    distributed.initialize(backend=backend)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    mod, fn = target.split(":")
    result = getattr(importlib.import_module(mod), fn)(device, payload)
    with open(os.path.join(tmp, f"rank{distributed.rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _npt_result(pt, state, metrics):
    g = pt._gather
    return {"m": pt.states_by_temperature(state),
            "beta_to_slot": _np(state.beta_to_slot),
            "m_best": _np(g(state.m_best)), "e_best": _np(g(state.e_best)),
            "cl": _np(g(state.cl)), "do_nmc_slot": _np(g(state.do_nmc_slot)),
            "slot_energies": _np(metrics.slot_energies),
            "best": pt.best(state)[0]}


def _ensemble_result(ens, state, best):
    eb, mb = best
    return {"m": distributed.host_gather(state.m, ens.group),
            "beta_to_slot": distributed.host_gather(state.beta_to_slot,
                                                      ens.group),
            "e_best": eb, "m_best": mb}


def sharded_cases(device, payload=None, cases=SHARDED_CASES):
    """Every sharded engine at a small size on the current process group,
    from fixed seeds: {case: {field: numpy array}} with each case's states,
    labels and bests gathered, the same on every rank."""
    from ..io.generators import ea_2d, random_sk
    from .ensemble import EnsembleConfig, EnsemblePT
    from .ensemble_icm import EnsembleICM, EnsembleICMConfig
    from .ensemble_nmc import EnsembleNMC
    from .sharded_pt import ShardedNPT, ShardedNPTConfig
    from .spin_sharded import SpinShardedConfig, SpinShardedSweeper

    group = distributed.global_group()
    dev = distributed.rank_device(device)
    W = distributed.group_shape(group)[0]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    lbp = dict(lbp_max_iterations=8, lambda_start=2.0,
               lambda_reduction_factor=0.25)
    out = {}
    npt_cases = {
        "sharded_npt_kernel": (ea_2d(6, seed=2), dict(use_coloring=True)),
        "sharded_npt_k1": (ea_2d(6, seed=3),
                           dict(use_coloring=True, round_kernel="off")),
        "sharded_npt_seq": (random_sk(20, seed=1), dict(lbp_mode="dense"))}
    for name, (prob, kw) in npt_cases.items():
        if name not in cases:
            continue
        cfg = ShardedNPTConfig(sweeps_per_phase=3, num_cycles=2,
                               num_swapping_pairs=2, global_beta=2.0,
                               block_size=8, **lbp, **kw)
        pt = ShardedNPT(prob.normalized()[0], np.geomspace(0.3, 3.0, 8),
                        [False] * 6 + [True] * 2, cfg, group=group,
                        device=dev)
        st, met = pt.run_scanned(pt.init_state(gen(11)), 3)
        out[name] = _npt_result(pt, st, met)
    # ea_2d(6) is padded with empty blocks at 4 spin ranks
    for name, L, rows in (("spin", 6, 1),
                          ("spin_grid", 8, 2 if W % 2 == 0 else 1)):
        if name not in cases:
            continue
        sw = SpinShardedSweeper(ea_2d(L, seed=1), SpinShardedConfig(
            block_size=8), group=group, replica_ranks=rows, device=dev)
        st = sw.init_state(gen(12), 8)
        st, e1 = sw.sweeps(st, 3, 1.0)
        mask = torch.rand((sw.n_pad,), generator=gen(13),
                          device=dev) < 0.7
        st, _ = sw.sweeps(st, 3, 2.0, anneal=True, initial_beta=0.5,
                          update_mask=mask)
        st, e2 = sw.swap_round(st, 2, np.geomspace(0.3, 3.0, 8),
                               num_swapping_pairs=2)
        out[name] = {"m": sw.states(st), "energies": _np(e2),
                     "beta_to_slot": _np(st.beta_to_slot)}
    ens_cases = {
        "ensemble_nmc_kernel": ([ea_2d(4, seed=s) for s in range(4)],
                                dict(use_coloring=True, round_kernel="on")),
        "ensemble_nmc_plain": ([random_sk(12, seed=s) for s in range(3)],
                               dict(lbp_mode="dense"))}
    for name, (probs, kw) in ens_cases.items():
        if name not in cases:
            continue
        cfg = ShardedNPTConfig(sweeps_per_phase=3, num_cycles=1,
                               num_swapping_pairs=2, block_size=8, **lbp,
                               **kw)
        ens = EnsembleNMC([p.normalized()[0] for p in probs],
                          np.linspace(0.4, 2.5, 8), [False] * 6 + [True] * 2,
                          cfg, group=group, device=dev)
        st = ens.run_scanned(ens.init_state(gen(14)), 2)
        out[name] = _ensemble_result(ens, st, ens.best(st))
    icm_cases = {
        "ensemble_icm_kernel": ([ea_2d(4, seed=s) for s in range(4)],
                                dict(use_coloring=True, sweeps_per_round=6,
                                     hybrid_cold=2)),
        "ensemble_icm_plain": ([random_sk(12, seed=s) for s in range(3)],
                               dict(sweeps_per_round=4))}
    for name, (probs, kw) in icm_cases.items():
        if name not in cases:
            continue
        ens = EnsembleICM([p.normalized()[0] for p in probs],
                          np.linspace(0.4, 2.5, 4), EnsembleICMConfig(
                              num_subreplicas=4, block_size=8, **kw),
                          group=group, device=dev)
        st = ens.run_scanned(ens.init_state(gen(15)), 2)
        out[name] = _ensemble_result(ens, st, ens.best(st))
    if "ensemble_pt" in cases:
        probs = [random_sk(12, seed=s, h_scale=0.3).normalized()[0]
                 for s in range(4)]
        ens = EnsemblePT(probs, np.linspace(0.3, 2.0, 5), EnsembleConfig(
            num_replicas=5, sweeps_per_round=4, num_swapping_pairs=2,
            block_size=8), group=group, device=dev)
        st = ens.run(ens.init_state(gen(16)), 2)
        out["ensemble_pt"] = {
            "m": distributed.host_gather(st.m, group),
            "beta_to_slot": distributed.host_gather(st.beta_to_slot, group),
            "e_best": ens.best_energies(st), "m_best": ens.best_states(st)}
    if payload is not None:
        out["checks"] = _gather_checks(dev, group)
        out["snapshot"] = _snapshot_case(device, payload.get("save_dir"))
        if payload.get("dryrun"):
            out["dryrun"] = dryrun_multirank(device)
    return out


def _gather_checks(dev, group):
    """host_gather over uneven shards, gather_rows of bool rows, and
    whether 3 replicas refuse to divide over the group."""
    from ..io.generators import ea_2d
    from .sharded_pt import ShardedNPT, ShardedNPTConfig
    W, k = distributed.group_shape(group)
    full = torch.arange(21, dtype=torch.float32, device=dev).reshape(7, 3)
    full = full * 0.37 - 2.0
    rows = np.array_split(np.arange(7), W)[k]
    got = distributed.host_gather(full[rows[0]:rows[-1] + 1] if len(rows)
                                  else full[:0], group)
    flags = (torch.arange(8 * 5, device=dev).reshape(8, 5) % 3) == 0
    per = 8 // W
    bools = distributed.gather_rows(flags[k * per:(k + 1) * per], k * per, 8,
                                    group)
    try:
        ShardedNPT(ea_2d(4, seed=0), [0.5, 1.0, 2.0], [False] * 3,
                   ShardedNPTConfig(block_size=8), group=group, device=dev)
        raised = False
    except ValueError:
        raised = True
    sent = distributed.broadcast_(full * (k + 1), 0, group)
    return {"host_gather": got, "host_gather_want": _np(full),
            "broadcast": _np(sent),
            "gather_bool": _np(bools), "gather_bool_want": _np(flags),
            "indivisible_raises": raised}


def snapshot_engine(device=None):
    """The ShardedNPT (K4 route, 8 slots) of the save / restore checks, on
    the current process group."""
    from ..io.generators import ea_2d
    from .sharded_pt import ShardedNPT, ShardedNPTConfig
    return ShardedNPT(
        ea_2d(6, seed=5).normalized()[0], np.geomspace(0.3, 3.0, 8),
        [False] * 6 + [True] * 2, ShardedNPTConfig(
            sweeps_per_phase=3, num_cycles=1, num_swapping_pairs=2,
            block_size=8, use_coloring=True, lbp_max_iterations=8,
            lambda_start=2.0, lambda_reduction_factor=0.25),
        group=distributed.global_group(),
        device=distributed.rank_device(device))


def _snapshot_case(device, save_dir):
    """Two rounds, saved at world 2 under `save_dir`; at world 1 the
    gathered state and the state one round on."""
    pt = snapshot_engine(device)
    st, _ = pt.run(pt.init_state(torch.Generator(
        device=pt.device).manual_seed(17)), 2)
    W = pt.n_ranks
    if save_dir and W == 2:
        pt.save(st, os.path.join(save_dir, "npt_w2.npz"))
    out = {"m_raw": _np(pt._gather(st.m)), "e_best": _np(pt._gather(
        st.e_best)), "cl": _np(pt._gather(st.cl))}
    st, _ = pt.run(st, 1)
    out.update(m_after=_np(pt._gather(st.m)),
               beta_to_slot_after=_np(st.beta_to_slot))
    return out


def dryrun_multirank(device=None) -> dict:
    """The JAX package's dryrun_multichip on the current process group
    (world size 1 outside one): each engine's step at a small size with
    shape, finiteness and permutation checks; returns a summary."""
    from ..io.generators import ea_2d, random_sk
    from .ensemble import EnsembleConfig, EnsemblePT
    from .ensemble_nmc import EnsembleNMC
    from .sharded_pt import ShardedNPT, ShardedNPTConfig
    from .spin_sharded import SpinShardedConfig, SpinShardedSweeper

    group = distributed.global_group()
    dev = distributed.rank_device(device)
    W = distributed.group_shape(group)[0]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def check(cond, msg):
        if not cond:
            raise AssertionError(f"dryrun_multirank({W}): {msg}")

    small_lbp = dict(lbp_max_iterations=8, lambda_start=2.0,
                     lambda_reduction_factor=0.25)
    # --- replica-sharded NPT: sweeps + LBP + NMC phases + label swaps ---
    prob = random_sk(48, seed=0).normalized()[0]
    R = 2 * W
    k = max(R // 4, 1)
    pt = ShardedNPT(prob, np.linspace(0.3, 3.0, R), [False] * (R - k)
                    + [True] * k, ShardedNPTConfig(
                        sweeps_per_phase=4, num_cycles=1,
                        num_swapping_pairs=k, global_beta=2.0, block_size=16,
                        **small_lbp), group=group, device=dev)
    st, met = pt.round(pt.init_state(gen(0)))
    e = _np(met.slot_energies)
    check(e.shape == (R,) and np.isfinite(e).all(), "ShardedNPT energies")
    check(np.array_equal(_np(st.slot_to_beta)[_np(st.beta_to_slot)],
                         np.arange(R)), "label permutation corrupted")

    # --- instance-sharded PT ensemble ---
    ens = EnsemblePT([random_sk(32, seed=s).normalized()[0]
                      for s in range(W)], np.linspace(0.5, 2.5, 4),
                     EnsembleConfig(num_replicas=4, sweeps_per_round=4,
                                    num_swapping_pairs=1, block_size=16),
                     group=group, device=dev)
    est = ens.round(ens.init_state(gen(1)))
    check(np.isfinite(ens.best_energies(est)).all(), "EnsemblePT bests")

    # --- spin(J)-axis sharding ---
    sprob = ea_2d(8, seed=1)
    sw = SpinShardedSweeper(sprob, SpinShardedConfig(block_size=8),
                            group=group, device=dev)
    sst, se = sw.sweeps(sw.init_state(gen(2), 8), 4, beta=1.0)
    check(np.isfinite(_np(se)).all(), "spin-sharded energies")

    # --- 2-D (replica, spin) grid: ladder + PT swap round ---
    if W % 2 == 0 and W >= 4:
        sw2 = SpinShardedSweeper(sprob, SpinShardedConfig(block_size=8),
                                 group=group, replica_ranks=2, device=dev)
        st2 = sw2.init_state(gen(4), 8)
        st2, _ = sw2.sweeps(st2, 3, beta=2.0, anneal=True)
        st2, e2 = sw2.swap_round(st2, 3, np.geomspace(0.3, 3.0, 8),
                                 num_swapping_pairs=2)
        check(np.isfinite(_np(e2)).all(), "2-D grid energies")
        check(sorted(_np(st2.beta_to_slot).tolist()) == list(range(8)),
              "2-D grid labels")

    # --- instance-sharded NMC ensemble, plain route ---
    encfg = ShardedNPTConfig(sweeps_per_phase=3, num_cycles=1,
                             num_swapping_pairs=1, block_size=8,
                             lbp_mode="dense", lbp_max_iterations=6,
                             lambda_start=2.0, lambda_reduction_factor=0.25)
    enmc = EnsembleNMC([random_sk(24, seed=s).normalized()[0]
                        for s in range(W)], np.linspace(0.4, 2.5, 6),
                       [False] * 4 + [True] * 2, encfg, group=group,
                       device=dev)
    check(enmc.round_path in ("plain", "idle"), "EnsembleNMC plain route")
    ebn, _ = enmc.best(enmc.run_scanned(enmc.init_state(gen(5)), 2))
    check(ebn.shape == (W,) and np.isfinite(ebn).all(), "EnsembleNMC bests")

    # --- the whole-round kernel sharded over instances ---
    ckcfg = ShardedNPTConfig(sweeps_per_phase=2, num_cycles=1,
                             num_swapping_pairs=1, block_size=8,
                             use_coloring=True, lbp_mode="dense",
                             lbp_max_iterations=6, lambda_start=2.0,
                             lambda_reduction_factor=0.25, round_kernel="on")
    ekrn = EnsembleNMC([ea_2d(4, seed=s).normalized()[0] for s in range(W)],
                       np.linspace(0.4, 2.5, 8), [False] * 6 + [True] * 2,
                       ckcfg, group=group, device=dev)
    check(ekrn.round_path == "K4", f"EnsembleNMC route {ekrn.round_path}")
    ebk, _ = ekrn.best(ekrn.run_scanned(ekrn.init_state(gen(6)), 2))
    check(np.isfinite(ebk).all(), "EnsembleNMC kernel bests")

    # --- ShardedNPT whole-round kernel per replica shard ---
    skR = 8 * W
    skpt = ShardedNPT(ea_2d(6, seed=2).normalized()[0],
                      np.geomspace(0.3, 3.0, skR),
                      [False] * (skR - 2) + [True] * 2, ShardedNPTConfig(
                          sweeps_per_phase=3, num_cycles=1,
                          num_swapping_pairs=2, global_beta=2.0,
                          block_size=8, use_coloring=True,
                          round_kernel="on", **small_lbp),
                      group=group, device=dev)
    check(skpt.round_path == "K4", f"ShardedNPT route {skpt.round_path}")
    _, skmet = skpt.round(skpt.init_state(gen(7)))
    check(np.isfinite(_np(skmet.slot_energies)).all(),
          "ShardedNPT kernel energies")
    return {"world": W, "slot_energies": e.tolist(),
            "ensemble_pt_best": ens.best_energies(est).tolist(),
            "ensemble_nmc_best": ebn.tolist(),
            "ensemble_nmc_kernel_best": ebk.tolist()}
