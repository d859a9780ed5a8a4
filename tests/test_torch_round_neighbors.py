"""The whole-round kernels' neighbour layout and its plain round, on the CPU.

K4 and K5 read the couplings only through a `RoundNeighbors` layout built
from dense J or from the family's union tiles. Here, with inputs made from
seeds with numpy:
  * the layouts from dense J and from the tiles are equal, scatter back
    to J exactly, list a step's targets longest source list first and
    each target's sources in ascending order, take no entry from a
    padding tile and hold weight 0 where an instance lacks a union edge;
  * the plain round over the layout (`ensemble_round_neighbors_reference`,
    the kernels' phi association) equals the Pallas kernels in interpret
    mode (u = 0: m and m_best exact, energies to 1e-5) and the dense and
    tile plain versions: bit for bit on +-1 couplings, where phi is
    integer-valued, and on Gaussian couplings with equal states and
    energies to 1e-5 (the sums associate differently);
  * `EnsembleNMC` builds the layout once at setup and passes it to every
    launch;
  * the layout's steps are `sweep_steps` of the same couplings and, on a
    colored layout, its colour classes (chimera 8x8, the union of 20
    chimera 16x16, chimera 26x26; one block a step on dense uncoloured J);
  * the kernels' step gather (per target its step's sources block by
    block, acc from 0 per block) equals the block-by-block `phi_add` bit
    for bit on Gaussian couplings;
  * the CTA width is a function of the launch's slot count and the SMs.
The kernels themselves run only on a card (chip_smoke.py holds them against
this plain round).
"""

import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu.core.problem import block_problem
from nmc_tpu.io.generators import chimera_graph, ea_2d
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.round_pallas import (_phase_list, pallas_ensemble_round,
                                      pallas_ensemble_round_streamed)
from nmc_tpu.parallel.ensemble_nmc import _union_tiles
from nmc_tpu_torch.ops import round_cuda as rc
from nmc_tpu_torch.ops.sweeps_cuda import sweep_steps
from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig
from nmc_tpu_torch.parallel import ensemble_nmc as ten

I, R = 2, 8
BETA = np.array([[0.5, 20, 1.0, 30, 0.7, 25, 1.2, 12],
                 [12, 1.2, 0.4, 15, 25, 0.9, 1.1, 40]], np.float32)
DO_NMC = np.array([[False] * 5 + [True] * 3, [True, False] * 4])
# couplings the second instance lacks, per topology
DROP = {"ea": ((0, 1), (7, 13)), "chimera": ((0, 4), (1, 6))}


def _problems(kind, seeds, gaussian=False):
    """ea_2d(6) or chimera 2x2 instances, +-1 or Gaussian; the second
    lacks the couplings DROP[kind] of the union."""
    gen = ea_2d if kind == "ea" else (lambda seed, pm: chimera_graph(
        2, 2, seed=seed, pm=pm))
    args = (6,) if kind == "ea" else ()
    probs = [gen(*args, seed=s, pm=not gaussian).normalized()[0]
             for s in seeds]
    J = probs[1].J.copy()
    for a, b in DROP[kind]:
        assert J[a, b] != 0
        J[a, b] = J[b, a] = 0.0
    probs[1] = JProblem(J, probs[1].h)
    return probs


def _blocked(probs, kind):
    """Blocked with the union colouring: ea in blocks of 16 (n_pad 64),
    chimera 2x2 in blocks of 8 (K = 4, padding tiles aliasing column
    block 0)."""
    block = 16 if kind == "ea" else 8
    groups = color_groups(sum(np.abs(p.J) for p in probs))
    blocked = [block_problem(p, block_size=block, groups=groups,
                             dtype=np.float32) for p in probs]
    assert blocked[0].colored
    return blocked


def _dense(blocked):
    n = blocked[0].n_pad
    return np.stack([b.J_rows.reshape(n, n) for b in blocked])


def _layouts(kind, gaussian=False, seeds=(3, 4)):
    probs = _problems(kind, seeds, gaussian)
    blocked = _blocked(probs, kind)
    J = _dense(blocked)
    col_idx, J_tiles = _union_tiles(blocked)
    nd = rc.neighbors_from_dense(torch.as_tensor(J), blocked[0].block_size)
    nt = rc.neighbors_from_tiles(torch.as_tensor(col_idx),
                                 torch.as_tensor(J_tiles))
    return probs, blocked, J, (col_idx, J_tiles), nd, nt


def _entries(nbrs):
    """(row block, target, source offset in the block) of every entry,
    numpy."""
    B = nbrs.block_size
    counts = np.diff(nbrs.src_ptr.numpy())
    k = nbrs.src.numpy().astype(np.int64)
    return k // B, np.repeat(nbrs.tgt.numpy(), counts), k % B


def _inputs(blocked, seed, cl_frac=0.3):
    n = blocked[0].n_pad
    act = blocked[0].active
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((len(blocked), R, n)) < 0.5, -1.0, 1.0)
    m0 = m0.astype(np.float32)
    m0[..., ~act] = 1.0
    cl = (rng.random(m0.shape) < cl_frac) & act
    h = np.stack([b.h for b in blocked])
    return act, m0, cl, h


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


@pytest.mark.parametrize("kind", ["ea", "chimera"])
@pytest.mark.parametrize("gaussian", [False, True])
def test_layouts_from_dense_and_tiles_agree_and_scatter_back(kind, gaussian):
    probs, blocked, J, (col_idx, J_tiles), nd, nt = _layouts(kind, gaussian)
    B = blocked[0].block_size
    assert nd.block_size == nt.block_size == B
    assert nd.step_spins == nt.step_spins
    for f in ("step_ptr", "tgt_ptr", "tgt", "src_ptr", "src", "w"):
        x, y = getattr(nd, f), getattr(nt, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert (nd.tgt.dtype, nd.src.dtype) == (torch.int16, torch.int16)
    assert (nd.tgt_ptr.dtype, nd.src_ptr.dtype) == (torch.int32, torch.int32)
    assert nd.step_ptr.dtype == torch.int32
    b, j, kk = _entries(nd)
    w = nd.w.numpy()
    k = b * B + kk
    # the entries are the union's nonzero couplings, each once: no padding
    # tile adds one (chimera: a padding tile aliases column block 0 beside
    # a real tile of that block)
    union = np.any(J != 0, axis=0)
    assert len(k) == union.sum() and union[k, j].all()
    if kind == "chimera":
        real = np.any(J_tiles != 0, axis=(0, 3, 4))
        assert any(col_idx[r, 0] == 0 and real[r, 0] and not real[r].all()
                   for r in range(col_idx.shape[0]))
    back = np.zeros_like(J)
    back[:, k, j] = w
    np.testing.assert_array_equal(back, J)
    # within a step the targets go by source count, longest first, then
    # by j; within a target the sources ascend, and all lie in its step
    n = J.shape[1]
    count = np.diff(nd.src_ptr.numpy())
    t_step = np.repeat(np.arange(len(nd.tgt_ptr) - 1),
                       np.diff(nd.tgt_ptr.numpy()))
    key = (t_step * (n + 1) + n - count) * n + nd.tgt.numpy()
    assert (np.diff(key) > 0).all() and count.min() >= 1
    t_of = np.repeat(np.arange(len(count)), count)
    assert (np.diff(k)[t_of[1:] == t_of[:-1]] > 0).all()
    steps = nd.step_ptr.numpy()
    assert (np.searchsorted(steps, b, side="right") - 1 == t_step[t_of]).all()
    # the second instance lacks DROP[kind] (both directions): weight
    # exactly 0 there, the first instance's nonzero (original spin i sits
    # at blocked position inv_perm[i])
    pos = blocked[0].inv_perm
    for a, c in DROP[kind]:
        for src, dst in ((pos[a], pos[c]), (pos[c], pos[a])):
            e = np.flatnonzero((k == src) & (j == dst))
            assert len(e) == 1 and w[1, e[0]] == 0 and w[0, e[0]] != 0
    assert (w[0] != 0).all() and (w[1] == 0).sum() == 2 * len(DROP[kind])


def test_layout_holds_the_int16_limit():
    """Targets and sources up to n_pad - 1 = 32767 fit the int16 layout
    (row blocks 0 and nB - 1 couple, so they fall in two steps); a larger
    n_pad is refused."""
    B, nB = 128, 256
    tiles = torch.zeros((1, nB, 1, B, B))
    col_idx = torch.zeros((nB, 1), dtype=torch.int32)
    col_idx[0, 0], tiles[0, 0, 0, 5, B - 1] = nB - 1, 0.5      # 5 -> 32767
    tiles[0, nB - 1, 0, B - 1, 5] = 0.5                        # 32767 -> 5
    nbrs = rc.neighbors_from_tiles(col_idx, tiles)
    assert nbrs.tgt.tolist() == [nB * B - 1, 5]
    assert nbrs.src.tolist() == [5, nB * B - 1]
    assert nbrs.step_ptr.tolist() == [0, nB - 1, nB]
    assert nbrs.tgt_ptr.tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="int16"):
        rc.neighbors_from_tiles(torch.zeros((nB + 1, 1), dtype=torch.int32),
                                torch.zeros((1, nB + 1, 1, B, B)))


def _nbr_round(nbrs, h, act, m0, cl, **kw):
    return rc.ensemble_round_neighbors_reference(
        nbrs, *_t(h, act, m0, cl, DO_NMC, BETA), **kw)


def _assert_same(tr, jr, m0):
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.e_carried.numpy(),
                               np.asarray(jr.e_carried), rtol=0, atol=1e-5)
    assert (tr.m.numpy() != m0).any() and (tr.m.numpy() == -1).any()


@pytest.mark.parametrize("fuf", [1, 2])
def test_neighbor_round_matches_k4_pallas_interpret(fuf):
    """The dense layout's round against `pallas_ensemble_round` (u = 0)."""
    _, blocked, J, _, nd, _ = _layouts("ea", seeds=(0, 1))
    act, m0, cl, h = _inputs(blocked, 0)
    P = len(_phase_list(2, fuf))
    kw = dict(num_cycles=2, sweeps_per_phase=3, full_update_frequency=fuf)
    jr = pallas_ensemble_round(J, h, act.astype(np.float32), m0, cl, DO_NMC,
                               BETA, 7, block_size=16, interpret=True, **kw)
    tr = _nbr_round(nd, h, act, m0, cl, generator=None,
                    uniforms=torch.zeros((P, 3, I, R, J.shape[1])), **kw)
    _assert_same(tr, jr, m0)


def test_neighbor_round_matches_k5_pallas_interpret():
    """The tile layout's round against `pallas_ensemble_round_streamed`
    (u = 0) on tiles whose padding aliases column block 0."""
    _, blocked, _, (col_idx, J_tiles), _, nt = _layouts("chimera")
    act, m0, cl, h = _inputs(blocked, 1)
    kw = dict(num_cycles=2, sweeps_per_phase=3)
    jr = pallas_ensemble_round_streamed(col_idx, J_tiles, h,
                                        act.astype(np.float32), m0, cl,
                                        DO_NMC, BETA, 7, block_size=8,
                                        interpret=True, **kw)
    tr = _nbr_round(nt, h, act, m0, cl, generator=None,
                    uniforms=torch.zeros((6, 3, I, R, m0.shape[2])), **kw)
    _assert_same(tr, jr, m0)


@pytest.mark.parametrize("kind", ["ea", "chimera"])
@pytest.mark.parametrize("gaussian", [False, True])
def test_neighbor_round_matches_plain_versions(kind, gaussian):
    """Against the dense (K4) and tile (K5) plain versions with the same
    random uniforms: +-1 couplings bit for bit, flips included; Gaussian
    couplings with equal states, energies to 1e-5."""
    _, blocked, J, (col_idx, J_tiles), nd, _ = _layouts(kind, gaussian)
    act, m0, cl, h = _inputs(blocked, 2, cl_frac=0.5)
    n = m0.shape[2]
    kw = dict(num_cycles=2, sweeps_per_phase=4, full_update_frequency=2)
    P = len(_phase_list(2, 2))
    u = torch.as_tensor(np.random.default_rng(9).random((P, 4, I, R, n)),
                        dtype=torch.float32)
    args = _t(h, act, m0, cl, DO_NMC, BETA)
    flips = {k: torch.zeros((I, R), dtype=torch.int32)
             for k in ("nbrs", "dense", "tiles")}
    tr = rc.ensemble_round_neighbors_reference(
        nd, *args, None, uniforms=u, flips=flips["nbrs"], **kw)
    plains = {
        "dense": rc.ensemble_round_reference(
            torch.as_tensor(J), *args, None, uniforms=u, flips=flips["dense"],
            block_size=blocked[0].block_size, **kw),
        "tiles": rc.ensemble_round_sparse_reference(
            *_t(col_idx, J_tiles), *args, None, uniforms=u,
            flips=flips["tiles"], **kw)}
    assert (tr.m != torch.as_tensor(m0)).any()
    for name, p in plains.items():
        assert torch.equal(flips["nbrs"], flips[name]), name
        assert torch.equal(tr.m, p.m) and torch.equal(tr.m_best, p.m_best)
        if gaussian:
            for f in ("e_best", "e_carried"):
                torch.testing.assert_close(getattr(tr, f), getattr(p, f),
                                           rtol=0, atol=1e-5)
        else:
            for x, y in zip(tr, p):
                assert torch.equal(x, y), name


def test_neighbor_phi_is_the_kernel_association():
    """phi_of sums each target's sources from 0 in ascending order and adds
    row block after row block onto h: equal to that loop in f32, and to
    J m + h within rounding."""
    _, blocked, J, _, nd, _ = _layouts("chimera", gaussian=True)
    act, m0, cl, h = _inputs(blocked, 3)
    phi_of, _ = rc.neighbor_phi_fns(nd, torch.as_tensor(h))
    phi = phi_of(torch.as_tensor(m0)).numpy()
    B = nd.block_size
    b, j, kk = _entries(nd)
    w = nd.w.numpy()
    want = np.repeat(h[:, None, :], R, axis=1).astype(np.float32)
    src_ptr = nd.src_ptr.numpy()
    t_of = np.repeat(np.arange(len(src_ptr) - 1), np.diff(src_ptr))
    for bb in range(m0.shape[2] // B):
        for t in np.unique(t_of[b == bb]):
            acc = np.zeros((I, R), np.float32)
            for e in range(src_ptr[t], src_ptr[t + 1]):
                if b[e] == bb:
                    acc = acc + m0[:, :, bb * B + kk[e]] * w[:, None, e]
            want[:, :, nd.tgt[t]] += acc
    np.testing.assert_array_equal(phi, want)
    np.testing.assert_allclose(phi, m0 @ J + h[:, None, :], rtol=0,
                               atol=1e-5)


def test_wrapper_checks_the_layout_and_the_cpu_path_ignores_it():
    _, blocked, J, _, nd, _ = _layouts("ea", seeds=(0, 1))
    act, m0, cl, h = _inputs(blocked, 5)
    args = _t(J, h, act, m0, cl, DO_NMC, BETA)
    kw = dict(num_cycles=1, sweeps_per_phase=2, block_size=16)
    a = rc.ensemble_round(*args, torch.Generator().manual_seed(1), nbrs=nd,
                          **kw)
    b = rc.ensemble_round(*args, torch.Generator().manual_seed(1), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert rc.ensemble_round.launches == 0
    cpu = torch.device("cpu")
    rc._check_neighbors(nd, I, 64, 16, cpu)
    with pytest.raises(ValueError, match="block_size"):
        rc._check_neighbors(nd, I, 64, 8, cpu)
    with pytest.raises(ValueError, match="nbrs.w"):
        rc._check_neighbors(nd, I + 1, 64, 16, cpu)
    with pytest.raises(TypeError, match="int16"):
        rc._check_neighbors(nd._replace(src=nd.src.int()), I, 64, 16, cpu)
    with pytest.raises(TypeError, match="RoundNeighbors"):
        rc._check_neighbors(tuple(nd), I, 64, 16, cpu)
    assert rc._shared_bytes(2048, 128) == 7 * 2048 + 4 * 128


@pytest.mark.parametrize("size,path", [(2, "K4"), (16, "K5")])
def test_engine_builds_the_layout_once(size, path, monkeypatch):
    """EnsembleNMC builds the layout at setup from its own couplings and
    hands that one object to every round launch; run_scanned builds none."""
    from nmc_tpu_torch.io.generators import chimera_graph as t_chimera
    built, seen = [], []
    for name in ("neighbors_from_dense", "neighbors_from_tiles"):
        inner = getattr(ten, name)

        def counting(*a, _inner=inner, **k):
            built.append(1)
            return _inner(*a, **k)
        monkeypatch.setattr(ten, name, counting)
    for name in ("ensemble_round", "ensemble_round_sparse"):
        inner = getattr(ten, name)

        def recording(*a, _inner=inner, **k):
            seen.append(k["nbrs"])
            return _inner(*a, **k)
        monkeypatch.setattr(ten, name, recording)
    probs = [t_chimera(size, size, seed=s).normalized()[0] for s in (0, 1)]
    B = 8 if size == 2 else 128
    cfg = ShardedNPTConfig(use_coloring=True, block_size=B, num_cycles=1,
                           sweeps_per_phase=1, num_swapping_pairs=1)
    ens = EnsembleNMC(probs, [0.5, 1.0, 2.0, 4.0], [False] * 4, cfg,
                      device="cpu")
    assert ens.round_path == path and len(built) == 1
    want = (rc.neighbors_from_dense(ens.J_full, B) if path == "K4" else
            rc.neighbors_from_tiles(*ens._stream_tiles))
    for x, y in zip(ens.round_nbrs, want):
        assert x == y if isinstance(x, int) else torch.equal(x, y)
    state = ens.init_state(torch.Generator().manual_seed(0))
    ens.run_scanned(state, 2)
    assert len(built) == 1 and len(seen) == 2
    assert all(n is ens.round_nbrs for n in seen)


def _chimera_blocked(size, count, B=128):
    """`count` +-1 chimera size x size instances blocked with their union
    colouring in blocks of B, and the colour classes' boundaries in
    blocks; each instance's dense J is dropped once it is blocked."""
    union = 0
    for s in range(count):
        union = union + np.abs(chimera_graph(size, size, seed=s).J)
    groups = color_groups(union)
    del union
    blocked = [block_problem(chimera_graph(size, size, seed=s).normalized()[0],
                             block_size=B, groups=groups, dtype=np.float32)
               for s in range(count)]
    classes = np.cumsum([0] + [-(-len(g) // B) for g in groups])
    return blocked, classes.tolist()


def _block_pattern(blocked):
    """[nB, nB]: row block b couples to block c in some instance."""
    nB, B = blocked[0].num_blocks, blocked[0].block_size
    adj = np.zeros((nB, nB), dtype=bool)
    for bl in blocked:
        adj |= np.any(bl.J_rows.reshape(nB, B, nB, B) != 0, axis=(1, 3))
    return adj


@pytest.mark.parametrize("case", ["chimera8x8", "chimera16x16_x20",
                                  "chimera26x26", "dense_uncoloured"])
def test_steps_are_sweep_steps_and_the_colour_classes(case):
    """The layout's steps are the sweep kernels' rule on the same union
    couplings, and on a colored layout its colour classes (chimera 16x16:
    3 steps for 16 blocks); dense uncoloured J takes one block a step.
    Dense J (K4's input) up to n_pad 1536, the union tiles (K5's) above."""
    if case == "dense_uncoloured":
        rng = np.random.default_rng(11)
        J = rng.normal(size=(96, 96)).astype(np.float32)
        J = J + J.T
        np.fill_diagonal(J, 0.0)
        blocked = [block_problem(JProblem(J, np.zeros(96)), block_size=16,
                                 dtype=np.float32)]
        classes = list(range(7))
    else:
        size, count = {"chimera8x8": (8, 1), "chimera16x16_x20": (16, 20),
                       "chimera26x26": (26, 1)}[case]
        blocked, classes = _chimera_blocked(size, count)
    B, n_pad = blocked[0].block_size, blocked[0].n_pad
    if n_pad <= 1536:
        nbrs = rc.neighbors_from_dense(torch.as_tensor(_dense(blocked)), B)
    else:
        col_idx, J_tiles = _union_tiles(blocked)
        nbrs = rc.neighbors_from_tiles(torch.as_tensor(col_idx),
                                       torch.as_tensor(J_tiles))
    steps = nbrs.step_ptr.tolist()
    assert steps == sweep_steps(_block_pattern(blocked)) == classes
    assert nbrs.step_spins == B * max(np.diff(steps))
    if case == "chimera16x16_x20":
        assert len(steps) - 1 == 3 and blocked[0].num_blocks == 16
    # every target of a step lies outside it on a colored layout
    bounds = nbrs.step_ptr.long() * B
    t_step = torch.repeat_interleave(torch.arange(len(steps) - 1),
                                     torch.diff(nbrs.tgt_ptr.long()))
    inside = ((nbrs.tgt.long() >= bounds[t_step])
              & (nbrs.tgt.long() < bounds[t_step + 1]))
    assert bool(inside.any()) == (case == "dense_uncoloured")


def _step_gather(nbrs, phi, x, s, from_phi=False):
    """The kernels' gather of step s in numpy: per target, its sources in
    the step in ascending k; acc starts at 0 and adds x_k * w_kj (exact
    products, x in {0, +-2}) over one row block's sources, then phi[j] +=
    acc where the block changes and at the end. `from_phi` models the
    sweep kernels' association instead (acc from phi[j], one chain)."""
    B = nbrs.block_size
    tgt_ptr, src_ptr = nbrs.tgt_ptr.numpy(), nbrs.src_ptr.numpy()
    src, tgt, w = nbrs.src.numpy(), nbrs.tgt.numpy(), nbrs.w.numpy()
    s0 = int(nbrs.step_ptr[s]) * B
    phi = phi.copy()
    for t in range(tgt_ptr[s], tgt_ptr[s + 1]):
        j = tgt[t]
        p = phi[..., j]
        acc = p.copy() if from_phi else np.zeros_like(p)
        blk = src[src_ptr[t]] // B
        for e in range(src_ptr[t], src_ptr[t + 1]):
            k = int(src[e])
            if k // B != blk and not from_phi:
                p, acc, blk = p + acc, np.zeros_like(p), k // B
            acc = acc + x[..., k - s0] * w[:, None, e]
        phi[..., j] = acc if from_phi else p + acc
    return phi


@pytest.mark.parametrize("size,B", [(2, 8), (8, 32)])
def test_step_gather_is_the_block_walk_bit_for_bit(size, B):
    """On Gaussian f32 couplings and dm drawn in {0, +-2}, the step gather
    in the round kernels' association equals `neighbor_phi_fns`' phi_add
    over the step's blocks in order, bit for bit, in every step of a
    multi-block layout; the sweep kernels' association (acc from phi[j])
    rounds differently."""
    probs = [chimera_graph(size, size, seed=s, pm=False).normalized()[0]
             for s in (5, 6)]
    groups = color_groups(sum(np.abs(p.J) for p in probs))
    blocked = [block_problem(p, block_size=B, groups=groups,
                             dtype=np.float32) for p in probs]
    nbrs = rc.neighbors_from_dense(torch.as_tensor(_dense(blocked)), B)
    steps = nbrs.step_ptr.tolist()
    assert max(np.diff(steps)) > 1          # some step spans several blocks
    n_pad = blocked[0].n_pad
    rng = np.random.default_rng(size)
    h = np.stack([b.h for b in blocked])
    _, phi_add = rc.neighbor_phi_fns(nbrs, torch.as_tensor(h))
    phi0 = rng.normal(size=(2, R, n_pad)).astype(np.float32)
    dm = (2 * rng.integers(-1, 2, size=(2, R, n_pad))).astype(np.float32)
    differs = False
    for s in range(len(steps) - 1):
        s0, s1 = steps[s] * B, steps[s + 1] * B
        got = _step_gather(nbrs, phi0, dm[..., s0:s1], s)
        want = torch.as_tensor(phi0)
        for b in range(steps[s], steps[s + 1]):
            want = phi_add(want, torch.as_tensor(dm[..., b * B:(b + 1) * B]),
                           b)
        np.testing.assert_array_equal(got, want.numpy())
        assert (got != phi0).any()
        k1 = _step_gather(nbrs, phi0, dm[..., s0:s1], s, from_phi=True)
        differs |= bool((k1 != got).any())
    assert differs


@pytest.mark.parametrize("slots,sms,threads", [
    (640, 132, 256), (6400, 132, 256), (320, 132, 256), (133, 132, 256),
    (132, 132, 1024), (16, 132, 1024), (1, 132, 1024), (16, 8, 256)])
def test_cta_width_follows_the_slot_count(slots, sms, threads):
    """256 threads (five CTAs an SM) where the slots fill the SMs: the
    ensembles' 20 x 32 and EnsembleICM's 20 x 320; 1024 (one CTA an SM)
    where every slot has an SM of its own: ShardedNPT's 16 a card."""
    assert rc.round_threads(slots, sms) == threads
    assert threads in rc.ROUND_WIDTHS

