"""The port's induced-tree refinement (`tree_moves.py`, `refine.py`,
`beam_chimera.pad_to_chimera_grid`, `beam_chimera_cuda.quantize_problem`)
against nmc_tpu's copies of them on numpy-seeded chimera 4x4 and 8x8
instances: the same cells, the same descents, the same states.

The port departs from the JAX package in three places on purpose, each
tested here: the ILS 2x2 kick flips only the blocks inside the grid (on a
one-column grid JAX's aliases the next row), `refine_family` reads a pool
state file of another length by copying min(size, n_orig) entries (JAX's
raises), and `refine` without `--family` or `--state` is a usage error
(exit 2).
"""

import json

import numpy as np
import pytest

from nmc_tpu import beam_chimera as jbc
from nmc_tpu import beam_chimera_tpu as jbt
from nmc_tpu import campaign as jcamp
from nmc_tpu import refine as jref
from nmc_tpu import tree_moves as jtm
from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu_torch import beam_chimera as tbc
from nmc_tpu_torch import beam_chimera_cuda as tbt
from nmc_tpu_torch import campaign as tcamp
from nmc_tpu_torch import cli
from nmc_tpu_torch import refine as tref
from nmc_tpu_torch import tree_moves as ttm
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.exact_chimera import solve_exact_chimera
from nmc_tpu_torch.io.generators import chimera_graph


def _chimera(size, seed=0, q=None):
    """chimera_graph(size, size) with +-1 couplings, or with couplings and
    fields that are multiples of 1/q."""
    prob = chimera_graph(size, size, seed=seed)
    if q is None:
        return prob
    rng = np.random.default_rng(seed + 100)
    J = np.triu(prob.J != 0, 1) * rng.integers(-q, q + 1, prob.J.shape) / q
    h = rng.integers(-q // 2, q // 2 + 1, prob.n) / q
    return IsingProblem(J + J.T, h)


def _jprob(prob):
    return JProblem(prob.J, prob.h)


def _random_state(n, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], n)


@pytest.mark.parametrize("rows, cols", [(4, 4), (8, 8), (3, 5), (1, 6)])
def test_cell_sets_equal_jax(rows, cols):
    for v in range(8):
        assert ttm.comb_cells(rows, cols, v) == jtm.comb_cells(rows, cols, v)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(6):
        assert ttm.random_induced_tree(rows, cols, ra) == \
            jtm.random_induced_tree(rows, cols, rb)


@pytest.mark.parametrize("size, q", [(4, None), (4, 75), (8, None)])
def test_tree_refine_equals_jax(size, q):
    prob = _chimera(size, seed=1, q=q)
    s0 = _random_state(prob.n, 2)
    a = ttm.tree_refine(prob, s0, seed=4, extra_random=6, max_rounds=20)
    b = jtm.tree_refine(_jprob(prob), s0, seed=4, extra_random=6,
                        max_rounds=20)
    assert a[0] == b[0] and a[2] == b[2] and a[2] > 0
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0] <= prob.energy(s0)


def test_pad_to_chimera_grid_equals_jax():
    full = _chimera(4, seed=2)
    a, b = tbc.pad_to_chimera_grid(full), jbc.pad_to_chimera_grid(
        _jprob(full))
    assert a[0] is full and a[1:] == b[1:] == (4, 4, 128)
    # a DCL-style raster: the last row holds 2 of its 4 cells
    n = 14 * 8
    part = IsingProblem(full.J[:n, :n], full.h[:n] + 0.5)
    a, b = tbc.pad_to_chimera_grid(part), jbc.pad_to_chimera_grid(
        _jprob(part))
    assert a[1:] == b[1:] == (4, 4, n)
    np.testing.assert_array_equal(a[0].J, b[0].J)
    np.testing.assert_array_equal(a[0].h, b[0].h)
    assert a[0].n == 128
    sk = IsingProblem(np.ones((9, 9)) - np.eye(9), np.zeros(9))
    for fn in (tbc.pad_to_chimera_grid, jbc.pad_to_chimera_grid):
        with pytest.raises(ValueError):
            fn(sk)


def test_quantize_problem_equals_jax():
    for prob in (_chimera(4, seed=3), _chimera(4, seed=3, q=75),
                 _chimera(4, seed=4, q=8)):
        a, b = tbt.quantize_problem(prob), jbt.quantize_problem(_jprob(prob))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    g = chimera_graph(2, 2, seed=0, pm=False)      # Gaussian: no q
    for fn in (tbt.quantize_problem, jbt.quantize_problem):
        with pytest.raises(ValueError):
            fn(g)


@pytest.mark.parametrize("size", [4, 8])
def test_partition_crossover_equals_jax(size):
    prob = _chimera(size, seed=5, q=75)
    for seed in range(3):
        sa = _random_state(prob.n, 10 + seed)
        sb = sa.copy()
        flip = np.random.default_rng(seed).random(prob.n) < 0.2
        sb[flip] *= -1
        a = tref.partition_crossover(prob, sa, sb)
        b = jref.partition_crossover(_jprob(prob), sa, sb)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
        assert a[0] <= min(prob.energy(sa), prob.energy(sb)) + 1e-12
    same = tref.partition_crossover(prob, sa, sa)
    assert same[2] == 0 and same[0] == prob.energy(sa)


@pytest.mark.parametrize("size, q, target", [
    (2, 75, "gs"), (4, None, "descent"), (4, 75, None), (8, None, None),
    (8, 75, "descent")])
def test_tree_refine_state_equals_jax(size, q, target):
    """Without a target, and with one the descent reaches (the ground
    state at 2x2; at 4x4 and 8x8 the energy a plain descent ends at, so
    the target's stop is taken)."""
    prob = _chimera(size, seed=6, q=q)
    s0 = _random_state(prob.n, 7)
    target_raw = {"gs": lambda: solve_exact_chimera(prob)[0],
                  "descent": lambda: jtm.tree_refine(
                      _jprob(prob), s0, seed=9, extra_random=4)[0],
                  None: lambda: None}[target]()
    a = tref.tree_refine_state(prob, s0, target_raw=target_raw,
                               ils_seconds=0, seed=2, extra_random=8)
    b = jref.tree_refine_state(_jprob(prob), s0, target_raw=target_raw,
                               ils_seconds=0, seed=2, extra_random=8)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    a[2].pop("seconds"), b[2].pop("seconds")
    assert a[2] == b[2]
    assert abs(prob.energy(a[1]) - a[0]) < 1e-9
    if target_raw is not None:
        assert a[2]["hit"] is (a[0] <= target_raw + 1e-9)


def _kicks(monkeypatch, module, prob, seconds=0.05):
    """The states each ILS iteration of `module.tree_refine_state` hands to
    `tree_refine`, with every descent replaced by a return to the start
    state (so every kick starts from that same best state)."""
    seen = []

    def fake(p, s, **kw):
        seen.append(np.array(s, np.float64))
        return 0.0, seen[0].copy(), 0

    tm = ttm if module is tref else jtm
    monkeypatch.setattr(tm, "tree_refine", fake)
    s0 = _random_state(prob.n, 8)
    p = prob if module is tref else _jprob(prob)
    module.tree_refine_state(p, s0, target_int=-10 ** 9,
                             ils_seconds=seconds, seed=5)
    return seen[0], seen[1:]


def _expected_kicks(base, rows, cols, count, seed):
    """The kicks a 2x2 block square clipped to the grid gives, replaying
    the ILS's draws from default_rng(seed + 1)."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(count):
        sk = base.copy()
        r0 = int(rng.integers(max(rows - 1, 1)))
        c0 = int(rng.integers(max(cols - 1, 1)))
        for r, c in ((r0, c0), (r0 + 1, c0), (r0, c0 + 1), (r0 + 1, c0 + 1)):
            if r < rows and c < cols:
                b = (r * cols + c) * 8
                sk[b:b + 8] *= -1
        sk[rng.random(base.size) < 0.02] *= -1
        rng.integers(1 << 30)
        out.append(sk)
    return out


def test_ils_kick_stays_inside_the_grid(monkeypatch):
    """Fix of the ILS kick: on a 4 x 1 grid the 2x2 square covers cells
    (r0, 0) and (r0 + 1, 0) only; JAX's aliases (r0, 1) to (r0 + 1, 0),
    flipping that cell twice and reaching into row r0 + 2. On a 2 x 2 grid
    both packages kick alike."""
    tall = chimera_graph(4, 1, seed=1)
    base, kicks = _kicks(monkeypatch, tref, tall)
    assert kicks
    for got, want in zip(kicks, _expected_kicks(base, 4, 1, len(kicks), 5)):
        np.testing.assert_array_equal(got, want)
    _, jkicks = _kicks(monkeypatch, jref, tall)
    assert not all(np.array_equal(a, b) for a, b in zip(kicks, jkicks))
    square = chimera_graph(2, 2, seed=1)
    _, ka = _kicks(monkeypatch, tref, square)
    _, kb = _kicks(monkeypatch, jref, square)
    k = min(len(ka), len(kb))
    assert k and all(np.array_equal(a, b) for a, b in zip(ka[:k], kb[:k]))


def _write_chimera(path, prob):
    """`prob` in the reference's chimera dialect (1-indexed; diagonal lines
    carry h; the file holds the negated values)."""
    rows = [f"{i + 1} {i + 1} {float(-prob.h[i])!r}" for i in range(prob.n)
            if prob.h[i]]
    iu, ju = np.nonzero(np.triu(prob.J, 1))
    rows += [f"{i + 1} {j + 1} {float(-prob.J[i, j])!r}"
             for i, j in zip(iu, ju)]
    path.write_text("\n".join(rows) + "\n")


def _write_family(folder, count=2):
    """`count` chimera 2x2 instances (couplings in 1/75) with their exact
    ground states in groundstates_otn2d.txt; returns {name: (energy,
    state)}."""
    from nmc_tpu_torch.io.loaders import load_chimera
    folder.mkdir(parents=True)
    gs, lines = {}, []
    for k in range(count):
        name = f"{k + 1:03d}.txt"
        _write_chimera(folder / name, _chimera(2, seed=20 + k, q=75))
        e, s = solve_exact_chimera(load_chimera(str(folder / name)))
        gs[name] = (e, np.asarray(s, np.float64))
        bits = " ".join(str(int(x)) for x in (np.asarray(s) + 1) // 2)
        lines.append(f"{name} : {e!r} {bits}")
    (folder / "groundstates_otn2d.txt").write_text("\n".join(lines) + "\n")
    return gs


def _near(state, seed, flips=3):
    """`state` with `flips` random spins flipped: a start the descent
    brings back."""
    s = state.copy()
    s[np.random.default_rng(seed).choice(s.size, flips, replace=False)] *= -1
    return s


def _family(tmp_path, monkeypatch):
    folder = tmp_path / "fam"
    gs = _write_family(folder)
    spec = dict(kind="chimera", folder=str(folder), coloring=True)
    monkeypatch.setattr(tcamp, "FAMILIES", {"chimera_t": spec})
    monkeypatch.setattr(jcamp, "FAMILIES", {"chimera_t": spec})
    monkeypatch.chdir(tmp_path)
    return folder, gs


def test_refine_family_equals_jax(tmp_path, monkeypatch):
    """refine_family over a written family folder, its pool in
    `state_dirs`: every instance reaches its ground state, the rows equal
    JAX's, and the improved states go back to the beam pool."""
    folder, gs = _family(tmp_path, monkeypatch)
    pool = tmp_path / "pool"
    pool.mkdir()
    for k, name in enumerate(sorted(gs)):
        np.savetxt(pool / name, _near(gs[name][1], k), fmt="%d")
    assert tref.grid_family_folders() == {"chimera_t": str(folder)}
    hits, total = tref.refine_family("chimera_t", state_dirs=[str(pool)],
                                     out="t.jsonl", ils_seconds=0)
    jhits, jtotal = jref.refine_family("chimera_t", state_dirs=[str(pool)],
                                       out="j.jsonl", ils_seconds=0,
                                       write_states=False)
    assert (hits, total) == (jhits, jtotal) == (2, 2)
    rows = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text()
            .splitlines()]
    jrows = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text()
             .splitlines()]
    for r, j in zip(rows, jrows):
        r.pop("seconds"), j.pop("seconds")
        assert r == j and r["hit"]
    for name, (e, _) in gs.items():
        from nmc_tpu_torch.io.loaders import load_chimera
        s = np.loadtxt(tmp_path / "results" / "beam_states" / "chimera_t"
                       / name)
        assert abs(load_chimera(str(folder / name)).energy(s) - e) < 1e-9
    # a second pass skips what is on file
    assert tref.refine_family("chimera_t", state_dirs=[str(pool)],
                              out="t.jsonl") == (0, 0)
    with pytest.raises(ValueError, match="unknown grid family"):
        tref.refine_family("wishart_n40_a0.50")


def test_refine_family_reads_a_stale_pool_state(tmp_path, monkeypatch):
    """Fix of the pool reader: a state file of another length gives its
    first min(size, n_orig) spins (the rest +1) instead of raising, as
    JAX's reader does."""
    folder, gs = _family(tmp_path, monkeypatch)
    pool = tmp_path / "pool"
    pool.mkdir()
    for k, name in enumerate(sorted(gs)):
        full = _near(gs[name][1], k)
        np.savetxt(pool / name, (full[:24] if k == 0
                                 else np.concatenate([full, -full[:8]])),
                   fmt="%d")
    with pytest.raises(ValueError):
        jref.refine_family("chimera_t", state_dirs=[str(pool)],
                           out="j.jsonl", write_states=False)
    seen = []
    real = tref.tree_refine_state

    def spy(prob, s0, **kw):
        seen.append(np.array(s0))
        return real(prob, s0, **kw)

    monkeypatch.setattr(tref, "tree_refine_state", spy)
    hits, total = tref.refine_family("chimera_t", state_dirs=[str(pool)],
                                     out="t.jsonl", write_states=False,
                                     ils_seconds=5)
    assert total == 2 and hits >= 1
    np.testing.assert_array_equal(seen[0][:24], np.loadtxt(pool / "001.txt"))
    assert np.all(seen[0][24:] == 1.0)
    np.testing.assert_array_equal(seen[1], np.loadtxt(pool / "002.txt")[:32])


def test_refine_cli_without_state_is_a_usage_error(tmp_path, capsys):
    """Fix of the `refine` command: no --family and no --state (or no
    path) exits 2 with a usage message, where JAX's fails in
    np.loadtxt(None)."""
    path = tmp_path / "001.txt"
    _write_chimera(path, _chimera(2, seed=1))
    for argv in (["refine", str(path)], ["refine"],
                 ["refine", "--state", str(path)]):
        with pytest.raises(SystemExit) as e:
            cli.main([*argv, "--device", "cpu"])
        assert e.value.code == 2
        assert "--state" in capsys.readouterr().err
