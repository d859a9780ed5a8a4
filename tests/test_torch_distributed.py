"""The port's multi-rank layer on the CPU: real torch.distributed process
groups over gloo, one fresh interpreter per rank.

`nmc_tpu_torch.parallel.dryrun.sharded_cases` runs every sharded engine
(ShardedNPT on the K4, K1 and sequential routes; SpinShardedSweeper on the
spin axis and on a 2 x (W / 2) replica x spin grid; EnsembleNMC on the
kernel and plain routes; EnsembleICM on the kernel (hybrid) and plain
routes; EnsemblePT) from fixed seeds at world size 1, 2 and 4, one launch
per world size (`launch_ranks`), together with `dryrun_multirank`. Every
gathered state, label map, energy and best must equal world 1's bit for
bit (tolerance 0), on every rank: the draws are keyed by global rows and
the products run per row or per instance. The ensembles' families have 4
and 3 instances, so the plain routes' instance shards leave a rank idle
at world 2 and 4 (the largest rank count that divides I).

Also here: `distributed.initialize` without launch variables, `host_gather`
over uneven shards, `gather_rows` of bool rows, `broadcast_`, a replica
count that does not divide, ShardedNPT's save / restore (a world-2 snapshot restored at
world 1), and the `sharded` CLI's record, in process and under torchrun
(`python -m torch.distributed.run`, env:// through torchrun's variables)
at 1 and 2 ranks, which must print the same record.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from nmc_tpu_torch.parallel import distributed
from nmc_tpu_torch.parallel.dryrun import SHARDED_CASES, launch_ranks

WORLDS = (1, 2, 4)
TARGET = "nmc_tpu_torch.parallel.dryrun:sharded_cases"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank results]}, each launch with its own timeout; the world-2
    ShardedNPT snapshot is saved under the returned directory."""
    save_dir = str(tmp_path_factory.mktemp("snapshots"))
    out = {W: launch_ranks(TARGET, W, timeout=240,
                           payload={"dryrun": True, "save_dir": save_dir})
           for W in WORLDS}
    return out, save_dir


@pytest.mark.parametrize("case", SHARDED_CASES)
@pytest.mark.parametrize("world", (2, 4))
def test_sharding_invariance(runs, world, case):
    res, _ = runs
    ref = res[1][0][case]
    for k, rank_res in enumerate(res[world]):
        got = rank_res[case]
        assert set(got) == set(ref)
        for field, want in ref.items():
            np.testing.assert_array_equal(
                np.asarray(got[field]), np.asarray(want),
                err_msg=f"{case}.{field}, rank {k} of {world}")


def test_cases_move_labels_and_states(runs):
    """The invariance above is not vacuous: labels moved and bests are
    finite in every case."""
    ref = runs[0][1][0]
    for case in SHARDED_CASES:
        r = ref[case]
        assert np.all(np.isfinite(np.asarray(r.get("e_best",
                                                   r.get("energies")))))
    moved = [case for case in SHARDED_CASES
             if not np.array_equal(
                 np.asarray(ref[case]["beta_to_slot"]),
                 np.broadcast_to(np.arange(np.shape(
                     ref[case]["beta_to_slot"])[-1]),
                     np.shape(ref[case]["beta_to_slot"])))]
    assert len(moved) >= len(SHARDED_CASES) - 2, moved


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_multirank(runs, world):
    for k, rank_res in enumerate(runs[0][world]):
        d = rank_res["dryrun"]
        assert d["world"] == world
        assert len(d["slot_energies"]) == 2 * world
        assert len(d["ensemble_nmc_kernel_best"]) == world
        assert d == runs[0][world][0]["dryrun"], f"rank {k} disagrees"


@pytest.mark.parametrize("world", WORLDS)
def test_gather_and_divisibility_checks(runs, world):
    checks = runs[0][world][0]["checks"]
    np.testing.assert_array_equal(checks["host_gather"],
                                  checks["host_gather_want"])
    np.testing.assert_array_equal(checks["gather_bool"],
                                  checks["gather_bool_want"])
    for rank_res in runs[0][world]:     # rank 0's tensor on every rank
        np.testing.assert_array_equal(rank_res["checks"]["broadcast"],
                                      checks["host_gather_want"])
    # 3 replicas divide over 1 rank only
    assert checks["indivisible_raises"] == (world > 1)


def test_snapshot_restores_at_world_one(runs):
    """A ShardedNPT snapshot written by rank 0 of a world-2 run restores in
    one process with every slot, and runs on as world 1 does."""
    from nmc_tpu_torch.parallel.dryrun import snapshot_engine
    res, save_dir = runs
    pt = snapshot_engine("cpu")
    st = pt.restore(os.path.join(save_dir, "npt_w2.npz"))
    ref = res[1][0]["snapshot"]
    np.testing.assert_array_equal(st.m.numpy(), ref["m_raw"])
    np.testing.assert_array_equal(st.e_best.numpy(), ref["e_best"])
    np.testing.assert_array_equal(st.cl.numpy(), ref["cl"])
    st, _ = pt.run(st, 1)
    np.testing.assert_array_equal(st.m.numpy(), ref["m_after"])
    np.testing.assert_array_equal(st.beta_to_slot.numpy(),
                                  ref["beta_to_slot_after"])


def test_save_restore_round_trip_in_process(tmp_path):
    from nmc_tpu_torch.parallel.dryrun import snapshot_engine
    pt = snapshot_engine("cpu")
    st, _ = pt.run(pt.init_state(torch.Generator().manual_seed(3)), 2)
    path = str(tmp_path / "npt.npz")
    pt.save(st, path)
    back = pt.restore(path)
    for f in ("m", "beta_to_slot", "slot_to_beta", "m_best", "e_best", "cl",
              "do_nmc_slot"):
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    assert back.round_index == st.round_index
    a, _ = pt.round(st)
    b, _ = pt.round(back)
    assert torch.equal(a.m, b.m) and torch.equal(a.beta_to_slot,
                                                 b.beta_to_slot)


def test_initialize_is_a_noop_without_launch_variables(monkeypatch):
    for k in ("NMC_TPU_COORDINATOR", "NMC_TPU_NUM_PROCESSES",
              "NMC_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize_from_env() is False
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.global_group() is None
    assert not distributed.is_multiprocess()
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1")


def test_world_one_helpers():
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(distributed.gather_rows(x, 0, 3), x)
    np.testing.assert_array_equal(distributed.host_gather(x), x.numpy())
    assert distributed.instance_shard(5, None) == (0, 5)
    assert distributed.grid_groups(1) == (None, None, 0, 0)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.rank_device()


def test_sharded_cli_prints_the_jax_record(tmp_path):
    from nmc_tpu_torch.cli import main
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.io.writers import save_edgelist
    path = str(tmp_path / "sk.txt")
    prob = random_sk(24, seed=4)
    save_edgelist(path, prob)
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["sharded", "--instance", path, "--device", "cpu",
              "--replicas", "8", "--rounds", "3", "--chunk-rounds", "2",
              "--sweeps-per-phase", "4", "--cycles", "1",
              "--nmc-coldest", "2", "--block-size", "8"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(rec) == {"min_energy", "rounds", "replicas", "devices",
                        "processes", "last_chunk_swap_accepts"}
    assert rec["rounds"] == 3 and rec["replicas"] == 8
    assert rec["devices"] == rec["processes"] == 1
    assert np.isfinite(rec["min_energy"])


def test_sharded_cli_under_torchrun_prints_one_record_at_any_world(tmp_path):
    from nmc_tpu_torch.io.generators import random_sk
    jpath = str(tmp_path / "J.npy")
    np.save(jpath, random_sk(32, seed=3).J)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NMC_TPU_", "MASTER_", "LOCAL_RANK"))}
    env.update(OMP_NUM_THREADS="1")
    recs = []
    for world in (1, 2):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(world), "-m", "nmc_tpu_torch",
             "sharded", "--J", jpath, "--device", "cpu", "--nmc-coldest",
             "2", "--rounds", "2", "--sweeps-per-phase", "4", "--cycles",
             "1", "--block-size", "8", "--replicas", "8"],
            capture_output=True, text=True, timeout=240, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert out.returncode == 0, out.stderr[-3000:]
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, out.stdout        # rank 0 prints
        recs.append(json.loads(lines[0]))
    assert recs[1]["processes"] == recs[1]["devices"] == 2
    for k in ("min_energy", "rounds", "replicas", "last_chunk_swap_accepts"):
        assert recs[0][k] == recs[1][k], k
