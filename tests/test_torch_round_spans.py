"""The ensemble engines' sync-free round spans and counters
(`utils.metrics.RoundSpans`, `count`, `host_sync`) on the CPU.

A `timings` dict changes no trajectory; each engine fills its own key set,
which `json.dumps` takes; the LBP counters count the trips of
`iterate_per_chain`; "host_syncs" counts every `host_sync` call of a round;
rounds whose events the card has not passed wait until `collect` (after
`best`) or `flush`; and without a dict no profiler span is entered. The
`sharded` command logs one `round_spans` record a chunk with `--metrics`.
"""

import collections
import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from nmc_tpu_torch.io.generators import chimera_graph, random_sk
from nmc_tpu_torch.ops import clusters, lbp_jit, lbp_planes
from nmc_tpu_torch.ops import round_cuda as rc
from nmc_tpu_torch.parallel import (EnsembleConfig, EnsembleICM,
                                    EnsembleICMConfig, EnsembleNMC,
                                    EnsemblePT, ShardedNPT, ShardedNPTConfig)
from nmc_tpu_torch.parallel import ensemble_icm, ensemble_nmc, sharded_pt
from nmc_tpu_torch.utils import metrics

BETA = np.array([0.3, 0.5, 0.8, 1.2, 1.6, 1.9, 3.0, 6.0])
DO_NMC = [False] * 6 + [True] * 2
ROUNDS = 3
ENGINES = ["EnsembleNMC", "ShardedNPT", "EnsemblePT", "EnsembleICM"]
BASE_KEYS = {"rounds", "host_s", "host_syncs"}
KEYS = {
    "EnsembleNMC": BASE_KEYS | {"lbp", "round", "swaps", "lbp_refreshes",
                                "lbp_iterations"},
    "ShardedNPT": BASE_KEYS | {"lbp", "round", "swaps", "lbp_refreshes",
                               "lbp_iterations", "compute_ms_by_round"},
    "EnsemblePT": BASE_KEYS | {"fields", "round", "swaps"},
    "EnsembleICM": BASE_KEYS | {"round", "houdayer", "swaps",
                                "houdayer_steps", "houdayer_pairs"},
}
# the round kernels' step counters: a K4/K5 launch on the card adds them,
# the plain round on the CPU walks no steps and counts none
STEPS = {"round_steps", "round_blocks"}
# the sweeps of one K4 launch a round: 3 phases a cycle, 2 cycles, of 3
# sweeps each (ICM: sweeps_per_round 6 over the 6 phases)
KERNEL_SWEEPS = {"EnsembleNMC": 18, "ShardedNPT": 18, "EnsembleICM": 6}
ENGINE_MODULES = {"EnsembleNMC": ensemble_nmc, "ShardedNPT": sharded_pt,
                  "EnsembleICM": ensemble_icm}
STAGES = {"EnsembleNMC": 3, "ShardedNPT": 3, "EnsemblePT": 3,
          "EnsembleICM": 3}


def _chimeras(count=2):
    return [chimera_graph(2, 2, seed=s).normalized()[0] for s in range(count)]


class EngineRun:
    """One engine built small on the CPU, driven a round at a time through
    its own call, with `best` and the fields its trajectory is made of."""

    def __init__(self, name):
        self.name = name
        if name == "EnsembleNMC":
            self.eng = EnsembleNMC(_chimeras(), BETA, DO_NMC, ShardedNPTConfig(
                sweeps_per_phase=3, num_cycles=2, num_swapping_pairs=2,
                use_coloring=True, block_size=16, lbp_every=1,
                lbp_tolerance=1e-4, lbp_mode="planes"), device="cpu")
            self.fields = ("m", "beta_to_slot", "e_best", "m_best", "cl")
        elif name == "ShardedNPT":
            self.eng = ShardedNPT(_chimeras(1)[0], BETA, DO_NMC,
                                  ShardedNPTConfig(
                                      sweeps_per_phase=3, num_cycles=2,
                                      num_swapping_pairs=2, use_coloring=True,
                                      block_size=16, lbp_tolerance=1e-4),
                                  device="cpu")
            self.fields = ("m", "beta_to_slot", "e_best", "m_best", "cl")
        elif name == "EnsemblePT":
            self.eng = EnsemblePT(
                [random_sk(24, seed=s) for s in range(3)], BETA[:5],
                EnsembleConfig(num_replicas=5, sweeps_per_round=3,
                               num_swapping_pairs=2, block_size=8),
                device="cpu")
            self.fields = ("m", "beta_to_slot", "best_e", "best_m")
        else:
            self.eng = EnsembleICM(_chimeras(), BETA, EnsembleICMConfig(
                sweeps_per_round=6, num_subreplicas=4, num_swapping_pairs=2,
                use_coloring=True, block_size=16, hybrid_cold=3,
                temp_x=10.0, num_cycles=2), device="cpu")
            self.fields = ("m", "beta_to_slot", "e_best", "m_best",
                           "icm_moves")

    def init(self, seed=4):
        return self.eng.init_state(torch.Generator().manual_seed(seed))

    def round(self, state, timings=None):
        if self.name == "EnsemblePT":
            return self.eng.round(state, timings=timings)
        if self.name == "ShardedNPT":
            return self.eng.run_scanned(state, 1, timings=timings)[0]
        return self.eng.run_scanned(state, 1, timings=timings)

    def best(self, state):
        if self.name == "EnsemblePT":
            return (self.eng.best_energies(state),
                    self.eng.best_states(state))
        return self.eng.best(state)

    def run(self, rounds, timings=None):
        s = self.init()
        for _ in range(rounds):
            s = self.round(s, timings)
        return s


@pytest.fixture(scope="module")
def runs():
    return {name: EngineRun(name) for name in ENGINES}


@pytest.mark.parametrize("name", ENGINES)
def test_timings_leave_the_trajectory_bit_for_bit(runs, name):
    d = runs[name]
    plain = d.run(ROUNDS)
    timings = {}
    traced = d.run(ROUNDS, timings)
    for f in d.fields:
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
    assert plain.round_index == traced.round_index == ROUNDS
    for a, b in zip(d.best(plain), d.best(traced)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ENGINES)
def test_each_engine_fills_its_key_set_as_json(runs, name):
    d = runs[name]
    timings = {}
    d.best(d.run(ROUNDS, timings))
    assert set(timings) == KEYS[name]
    assert timings["rounds"] == ROUNDS
    back = json.loads(json.dumps(timings))
    assert back == timings
    for k, v in timings.items():
        if k == "compute_ms_by_round":
            assert len(v) == ROUNDS and all(isinstance(x, float) for x in v)
        else:
            assert isinstance(v, (int, float)) and v >= 0, k
    if name in ("EnsembleNMC", "ShardedNPT"):
        # every round refreshes: one ladder for the ensemble's batch, one
        # per NMC slot on the replica-sharded engine
        per_round = 1 if name == "EnsembleNMC" else sum(DO_NMC)
        assert timings["lbp_refreshes"] == ROUNDS * per_round
        assert timings["lbp_iterations"] >= timings["lbp_refreshes"]


def _count_like_a_launch(monkeypatch, module):
    """Stand `module`'s K4 wrapper in with one that first counts the steps
    of its sweeps as a launch on the card does (`round_cuda._count_steps`),
    then runs the plain round."""
    plain = module.ensemble_round

    def counted(J, *args, nbrs, **kw):
        rc._count_steps(nbrs, J.shape[-1], dict(
            num_cycles=kw["num_cycles"],
            sweeps_per_phase=kw["sweeps_per_phase"],
            full_update_frequency=kw.get("full_update_frequency", 1)))
        return plain(J, *args, nbrs=nbrs, **kw)

    monkeypatch.setattr(module, "ensemble_round", counted)


@pytest.mark.parametrize("name", sorted(KERNEL_SWEEPS))
def test_round_kernel_engines_count_steps_and_blocks(runs, name,
                                                     monkeypatch):
    """The plain round on the CPU counts no steps. A K4/K5 launch adds its
    sweeps' steps (the layout's, a colour class each) and the block steps
    a block-by-block walk would take: host integers of the layout, so
    counting them syncs nothing."""
    d = runs[name]
    timings = {}
    d.best(d.run(ROUNDS, timings))
    assert not STEPS & set(timings)
    _count_like_a_launch(monkeypatch, ENGINE_MODULES[name])
    timings = {}
    d.best(d.run(ROUNDS, timings))
    assert set(timings) == KEYS[name] | STEPS
    nbrs = d.eng.round_nbrs
    n_steps = nbrs.step_ptr.numel() - 1
    n_blocks = d.eng.n_pad // nbrs.block_size
    sweeps = ROUNDS * KERNEL_SWEEPS[name]
    assert d.eng.round_path == "K4" and 1 <= n_steps <= n_blocks
    assert timings["round_steps"] == sweeps * n_steps
    assert timings["round_blocks"] == sweeps * n_blocks


@pytest.mark.parametrize("converge_at,max_iterations",
                         [(1, 30), (4, 30), (30, 30), (12, 8)])
def test_lbp_iterations_count_the_trips_of_iterate_per_chain(converge_at,
                                                             max_iterations):
    trips = []

    def step(carry):
        trips.append(1)
        (x,) = carry
        done = torch.full((3,), len(trips) >= converge_at)
        return (x + 1,), done

    spans = metrics.RoundSpans("Test", torch.device("cpu"))
    timings = {}
    with spans.round(timings):
        with spans.stage("lbp"):
            (x,), conv = lbp_jit.iterate_per_chain(
                step, (torch.zeros(3, 2),), max_iterations)
    ran = min(converge_at, max_iterations)
    assert len(trips) == ran and timings["lbp_iterations"] == ran
    assert bool(conv.all()) == (converge_at <= max_iterations)
    assert torch.equal(x, torch.full((3, 2), float(ran)))
    # one convergence read before each trip, and one more that ends the
    # loop unless max_iterations ended it
    assert timings["host_syncs"] == ran + (converge_at < max_iterations)
    assert "lbp_refreshes" not in timings


@pytest.mark.parametrize("name", ENGINES)
def test_host_syncs_count_every_host_sync_of_a_round(runs, name,
                                                     monkeypatch):
    """"host_syncs" is the round's `host_sync` calls, and these are the
    backbone's and the Houdayer labels' reads alone, each site its exact
    count: per LBP refresh the plane operands (3), the NMC slots' list
    (ShardedNPT) and one convergence read before each trip plus one for
    each loop that converged; per Houdayer stage one read every
    `_CHECK_EVERY` steps. The swaps and EnsemblePT's round read nothing."""
    calls = []
    inner = metrics.host_sync
    for mod in (lbp_jit, lbp_planes, clusters, ensemble_nmc, ensemble_icm,
                sharded_pt):
        def counting(fn, *args, _site=mod.__name__.rsplit(".", 1)[1], **kw):
            out = inner(fn, *args, **kw)
            calls.append((_site, out))
            return out

        monkeypatch.setattr(mod, "host_sync", counting)
    d = runs[name]
    s = d.round(d.init())
    calls.clear()
    timings = {}
    d.round(s, timings)
    assert timings["rounds"] == 1
    assert timings["host_syncs"] == len(calls)
    sites = collections.Counter(site for site, _ in calls)
    converged = sum(out is False for site, out in calls if site == "lbp_jit")
    lbp = {"lbp_planes": 3 * timings.get("lbp_refreshes", 0),
           "lbp_jit": timings.get("lbp_iterations", 0) + converged}
    want = {"EnsembleNMC": lbp,
            "ShardedNPT": {**lbp, "sharded_pt": 1},
            "EnsemblePT": {},
            "EnsembleICM": {"clusters": -(-timings.get("houdayer_steps", 0)
                                          // clusters._CHECK_EVERY)}}[name]
    assert dict(sites) == want
    assert (len(calls) > 0) == (name != "EnsemblePT")


def test_icm_counts_houdayer_steps_and_pairs_without_a_sync(runs,
                                                           monkeypatch):
    """One EnsembleICM round from one state three ways: plain, with
    `houdayer_stats`, with `timings`. The counters equal the fixed-point
    loop's steps and the pairs moved, and counting them syncs nothing and
    changes no state bit: one convergence read every `_CHECK_EVERY` steps,
    with or without the dict."""
    calls = []
    inner = metrics.host_sync

    def counting(fn, *args, **kw):
        calls.append(fn)
        return inner(fn, *args, **kw)

    for mod in (clusters, ensemble_icm):
        monkeypatch.setattr(mod, "host_sync", counting)
    d = runs["EnsembleICM"]
    eng = d.eng
    s = d.round(d.init())
    gen = s.generator.get_state()

    def once(**kw):
        s.generator.set_state(gen)
        calls.clear()
        return eng.run_scanned(s, 1, **kw), len(calls)

    plain, plain_syncs = once()
    stats = {}
    once(houdayer_stats=stats)
    timings = {}
    traced, traced_syncs = once(timings=timings)
    assert timings["houdayer_steps"] == stats["steps"] > 0
    assert timings["houdayer_pairs"] == eng.I * (eng.S // 2) * eng.R
    assert timings["host_syncs"] == traced_syncs == plain_syncs
    assert plain_syncs == -(-stats["steps"] // clusters._CHECK_EVERY)
    for f in plain._fields:
        a, b = getattr(plain, f), getattr(traced, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f


class FakeEvent:
    """A CUDA event stand-in: it has happened once its card says so."""

    def __init__(self, card):
        self.card, self.t = card, card["clock"]
        card["clock"] += 1.0

    def query(self):
        return self.card["done"]

    def synchronize(self):
        self.card["done"] = True

    def elapsed_time(self, other):
        assert self.card["done"]
        return 1e3 * (other.t - self.t)      # ms, one "second" a point


def _pending_engine(monkeypatch):
    card = {"done": False, "clock": 0.0}

    def point(rnd):
        rnd.last = FakeEvent(card)
        return rnd.last

    monkeypatch.setattr(metrics._Round, "point", point)
    d = EngineRun("EnsembleNMC")
    d.eng._spans.cuda = True
    return d, card


@pytest.mark.parametrize("resolve", ["best", "flush"])
def test_pending_rounds_land_at_best_or_flush(monkeypatch, resolve):
    d, card = _pending_engine(monkeypatch)
    timings = {}
    s = d.run(ROUNDS, timings)
    assert timings == {}                       # the card has not passed them
    assert len(d.eng._spans._pending) == ROUNDS
    if resolve == "best":
        card["done"] = True                    # the gather waits for the card
        d.best(s)
    else:
        d.eng.flush()
    assert not d.eng._spans._pending
    assert timings["rounds"] == ROUNDS
    # three stages a round, each from its start point to its end point
    for k in ("lbp", "round", "swaps"):
        assert timings[k] == pytest.approx(ROUNDS * 1.0)


def test_finished_rounds_land_without_waiting(monkeypatch):
    d, card = _pending_engine(monkeypatch)
    timings = {}
    s = d.run(2, timings)
    assert timings == {}
    card["done"] = True
    d.round(s, timings)                        # collect after the round
    assert timings["rounds"] == 3 and not d.eng._spans._pending


@pytest.mark.parametrize("name", ENGINES)
def test_no_dict_enters_no_profiler_span(runs, name, monkeypatch):
    import torch.profiler
    entered = []

    class Counting:
        def __init__(self, label):
            self.label = label

        def __enter__(self):
            entered.append(self.label)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    d = runs[name]
    d.run(2)
    assert entered == []
    d.run(2, {})
    assert len(entered) == 2 * STAGES[name]
    assert all(x.startswith(name + ".") for x in entered)


def test_host_seconds_leave_out_the_waits():
    spans = metrics.RoundSpans("Test", torch.device("cpu"))
    timings = {}
    with spans.round(timings):
        with spans.stage("wait"):
            metrics.host_sync(time.sleep, 0.05)
    assert timings["host_syncs"] == 1 and timings["rounds"] == 1
    assert timings["host_s"] < 0.04 <= timings["wait"]
    metrics.host_sync(time.sleep, 0.0)         # no round: nothing counted
    metrics.count("lbp_iterations")
    assert timings["host_syncs"] == 1


def test_compute_ms_runs_from_the_last_collective(monkeypatch):
    """Each round's arrival is measured from the previous round's
    "collective_out"; a round after one with no dict starts afresh."""
    card = {"done": True, "clock": 0.0}
    monkeypatch.setattr(metrics._Round, "point",
                        lambda self: FakeEvent(card))
    spans = metrics.RoundSpans("Test", torch.device("cpu"))
    spans.cuda = True

    def one(timings, work):
        with spans.round(timings):
            with spans.stage("round"):
                card["clock"] += work
            with spans.stage("swaps"):
                spans.mark("collective_in")
                spans.mark("collective_out")

    timings = {}
    one(timings, 5.0)
    one(timings, 7.0)
    one(None, 0.0)
    one(timings, 2.0)
    # points: stage start, end, swaps start, in, out, swaps end (1 s each)
    assert timings["compute_ms_by_round"] == pytest.approx(
        [1e3 * 8.0, 1e3 * 12.0, 1e3 * 5.0])


def test_sharded_cli_logs_round_spans_a_chunk(tmp_path):
    from nmc_tpu_torch.cli import main
    from nmc_tpu_torch.io.writers import save_edgelist
    path = str(tmp_path / "sk.txt")
    save_edgelist(path, random_sk(24, seed=4))
    out = tmp_path / "metrics.jsonl"
    with redirect_stdout(io.StringIO()):
        main(["sharded", "--instance", path, "--device", "cpu",
              "--replicas", "8", "--rounds", "3", "--chunk-rounds", "2",
              "--sweeps-per-phase", "4", "--cycles", "1",
              "--nmc-coldest", "2", "--block-size", "8",
              "--metrics", str(out)])
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    spans = [r for r in recs if r["kind"] == "round_spans"]
    assert [r["rounds"] for r in spans] == [2, 1]
    for r in spans:
        assert r["rank"] == 0
        assert set(r) == {"kind", "t", "rank"} | KEYS["ShardedNPT"]
        assert len(r["compute_ms_by_round"]) == r["rounds"]
        assert r["lbp_refreshes"] == 2 * r["rounds"]


def test_sharded_cli_round_spans_carry_the_round_kernel_steps(
        tmp_path, monkeypatch):
    """On a colored chimera the `sharded` command routes to K4. Each
    `round_spans` record carries the steps and block steps its launches
    count, and none where the plain round ran them on the CPU."""
    from nmc_tpu_torch.cli import main
    from nmc_tpu_torch.io.writers import save_edgelist
    path = str(tmp_path / "chimera.txt")
    save_edgelist(path, chimera_graph(2, 2, seed=3))

    def spans(tag):
        out = tmp_path / f"{tag}.jsonl"
        with redirect_stdout(io.StringIO()):
            main(["sharded", "--instance", path, "--device", "cpu",
                  "--replicas", "8", "--rounds", "2", "--chunk-rounds", "2",
                  "--sweeps-per-phase", "4", "--cycles", "1", "--coloring",
                  "--block-size", "8", "--metrics", str(out)])
        recs = [json.loads(ln) for ln in out.read_text().splitlines()]
        recs = [r for r in recs if r["kind"] == "round_spans"]
        assert len(recs) == 1
        return recs[0]

    assert not STEPS & set(spans("plain"))
    _count_like_a_launch(monkeypatch, sharded_pt)
    r = spans("counted")
    assert STEPS <= set(r)
    # 2 rounds of one cycle, 3 phases of 4 sweeps; each colour class's
    # blocks make one step
    assert r["round_blocks"] % 24 == 0 and r["round_steps"] % 24 == 0
    assert 0 < r["round_steps"] < r["round_blocks"]
