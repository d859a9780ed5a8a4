"""The readers of the engines' round spans and counters against synthetic
records: the numbers they compute, and nothing (None) on a record whose
`timings` lack the keys, as a program without the spans writes it, or on a
rank that passes no `timings` at all."""

import pytest

from perfbench import harness

SPANS = ["host_ms_per_round", "host_syncs_per_round",
         "lbp_iterations_per_refresh.nmc", "rank_skew_ms_per_round"]


def rank(**timings):
    return dict(timings=timings or None, rounds=timings.get("rounds", 10),
                window_s=1.0)


def run(*ranks, nmc=6):
    return dict(ranks=list(ranks), traffic=dict(nmc_coldest=nmc))


def read(name, r):
    return harness.read_metric(name, r)


def test_host_ms_and_syncs_take_the_highest_rank():
    r = run(rank(rounds=40, host_s=0.4, host_syncs=40),
            rank(rounds=40, host_s=0.6, host_syncs=80))
    assert read("host_ms_per_round", r) == pytest.approx(15.0)
    assert read("host_syncs_per_round", r) == pytest.approx(2.0)


def test_lbp_iterations_a_refresh():
    r = run(rank(rounds=400, lbp_refreshes=50, lbp_iterations=10000))
    assert read("lbp_iterations_per_refresh.nmc", r) == pytest.approx(200.0)
    assert read("lbp_iterations_per_refresh.nmc", run(
        rank(rounds=400, lbp_refreshes=50, lbp_iterations=10000),
        nmc=0)) is None
    assert read("lbp_iterations_per_refresh.nmc", run(
        rank(rounds=400, lbp_refreshes=0, lbp_iterations=0))) is None


def test_rank_skew_aligns_rounds_by_index():
    r = run(rank(rounds=3, compute_ms_by_round=[40.0, 41.0, 40.0]),
            rank(rounds=3, compute_ms_by_round=[42.0, 40.0, 40.5]),
            rank(rounds=3, compute_ms_by_round=[41.0, 40.0, 43.0, 99.0]))
    # per round: 42 - 40, 41 - 40, 43 - 40; the fourth has one rank only
    assert read("rank_skew_ms_per_round", r) == pytest.approx(2.0)
    one = run(rank(rounds=3, compute_ms_by_round=[40.0, 41.0, 40.0]))
    assert read("rank_skew_ms_per_round", one) is None


@pytest.mark.parametrize("name", SPANS)
def test_nothing_to_read_without_the_spans(name):
    # the stage keys a program without the spans writes, and no timings
    parent = run(rank(lbp=0.5, round=3.0, swaps=0.2),
                 rank(lbp=0.4, round=3.1, swaps=0.3))
    assert read(name, parent) is None
    assert read(name, run(rank(), rank())) is None
