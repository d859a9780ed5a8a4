"""The sweep kernels' neighbour layout and its plain sweeps, on the CPU.

K1, K2 and K3 (csrc/colored_sweeps_nbr.cu) read the couplings only through a
`SweepNeighbors` layout: the row blocks cut into steps, per step the
targets coupled to it and per target its sources in the step. Here, with
inputs made from seeds with numpy:
  * on graph-coloured layouts of five families the steps are the colour
    classes and no step holds a coupled pair; the layouts from dense J and
    from the tiles are equal and scatter back to J;
  * the plain sweeps over the layout (`neighbor_sweeps_reference`, the
    kernel's steps and association) equal K2's and K3's plain twins bit for
    bit on +-1 couplings (f32), the Pallas K2/K3 in interpret mode (u = 0:
    m exact, phi and energies to 1e-5), and in f64 the JAX XLA Jacobi
    sweeps with JAX's uniforms injected (to 1e-10, Gaussian couplings too);
  * `SweepEngine` builds the layout once for every colored layout (K1's
    too) and passes it to every launch; an uncoloured f32 one gets the
    sequential kernel's block layout instead, an f64 one none;
    the int16 limit raises; the CTA width rule is a function of (R, SMs).
The kernel itself runs only on a card (chip_smoke.py holds it against
these plain sweeps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import block_problem, block_sparse_tiles
from nmc_tpu.io.generators import (chimera_graph, ea_2d, random_sk,
                                   wishart_planted)
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.sweeps import run_sweeps as j_run_sweeps
from nmc_tpu.ops.sweeps_pallas import (pallas_colored_sweeps_sparse,
                                       pallas_colored_sweeps_streamed)
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.io.generators import chimera_graph as t_chimera_graph
from nmc_tpu_torch.io.generators import ea_2d as t_ea_2d
from nmc_tpu_torch.ops import engine as t_engine
from nmc_tpu_torch.ops import sweeps_cuda as sc
from nmc_tpu_torch.ops.engine import SweepEngine

from torch_parity import jax_sweep_uniforms, t64


def _regular3(N, seed=0):
    """The union of three random perfect matchings with +-1 weights."""
    rng = np.random.default_rng(seed)
    J = np.zeros((N, N))
    for _ in range(3):
        p = rng.permutation(N)
        a, c = p[:N // 2], p[N // 2:]
        w = rng.choice([-1.0, 1.0], size=N // 2)
        J[a, c] = w
        J[c, a] = w
    return IsingProblem(J, np.zeros(N))


# (problem, block size): sparse lattices, a random regular graph, and two
# dense families whose greedy colourings have one spin per class
FAMILIES = {
    "chimera_2x2": lambda: (chimera_graph(2, 2, seed=3), 8),
    "ea2d_6_gaussian": lambda: (ea_2d(6, seed=1, pm=False), 16),
    "regular3_64": lambda: (_regular3(64, seed=2), 8),
    "wishart_12": lambda: (wishart_planted(12, 0.5, seed=4)[0], 4),
    "sk_10": lambda: (random_sk(10, seed=5), 4),
}


def _blocked(name, dtype=np.float32):
    prob, B = FAMILIES[name]()
    groups = color_groups(prob.J)
    b = block_problem(prob, block_size=B, groups=groups, dtype=dtype)
    assert b.colored
    return prob, groups, b


def _nbrs(b):
    """The layouts from dense J and from the tiles, and the tiles."""
    col_idx, J_tiles = block_sparse_tiles(b)
    nd = sc.sweep_neighbors_from_dense(torch.as_tensor(b.J_rows))
    nt = sc.sweep_neighbors_from_tiles(torch.as_tensor(col_idx),
                                       torch.as_tensor(J_tiles))
    return nd, nt, col_idx, J_tiles


def _entries(nbrs):
    """(step, target, source spin) of every entry, numpy."""
    counts = np.diff(nbrs.src_ptr.numpy())
    t_step = np.repeat(np.arange(len(nbrs.tgt_ptr) - 1),
                       np.diff(nbrs.tgt_ptr.numpy()))
    return (np.repeat(t_step, counts), np.repeat(nbrs.tgt.numpy(), counts),
            nbrs.src.numpy())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_steps_are_the_colour_classes(name):
    """Greedy colouring gives each spin of class c + 1 a neighbour in class
    c, so no two consecutive classes merge: the steps are exactly the
    classes (each padded to whole blocks), and no step holds a coupled
    pair."""
    _, groups, b = _blocked(name)
    B = b.block_size
    nd = _nbrs(b)[0]
    classes = np.cumsum([0] + [-(-max(len(g), B) // B) for g in groups])
    assert nd.step_ptr.tolist() == classes.tolist()
    assert nd.step_ptr.dtype == torch.int32
    assert sc.steps_are_independent(nd)
    J = b.J_rows.reshape(b.n_pad, b.n_pad)
    for s0, s1 in zip(classes[:-1] * B, classes[1:] * B):
        assert not J[s0:s1, s0:s1].any()
    # a step made of two classes holds a coupled pair, and the check says so
    two = sc.sweep_neighbors_from_dense(
        torch.as_tensor(b.J_rows),
        steps=[0] + classes[2:].tolist())
    assert not sc.steps_are_independent(two)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_layouts_from_dense_and_tiles_agree_and_scatter_back(name):
    _, _, b = _blocked(name)
    nd, nt, _, _ = _nbrs(b)
    for f in sc.SweepNeighbors._fields:
        x, y = getattr(nd, f), getattr(nt, f)
        assert x == y if isinstance(x, int) else (
            x.dtype == y.dtype and torch.equal(x, y)), f
    assert (nd.tgt.dtype, nd.src.dtype) == (torch.int16, torch.int16)
    assert (nd.tgt_ptr.dtype, nd.src_ptr.dtype) == (torch.int32, torch.int32)
    g, j, k = _entries(nd)
    J = b.J_rows.reshape(b.n_pad, b.n_pad)
    assert len(k) == np.count_nonzero(J)
    back = np.zeros_like(J)
    back[k, j] = nd.w.numpy()
    np.testing.assert_array_equal(back, J)
    # every source lies in its step; within a step the targets go by source
    # count, longest first, then by j; within a target the sources ascend
    bounds = nd.step_ptr.numpy() * b.block_size
    assert ((k >= bounds[g]) & (k < bounds[g + 1])).all()
    count = np.diff(nd.src_ptr.numpy())
    t_step = np.repeat(np.arange(len(bounds) - 1),
                       np.diff(nd.tgt_ptr.numpy()))
    key = (t_step * (b.n_pad + 1) + b.n_pad - count) * b.n_pad + nd.tgt.numpy()
    assert (np.diff(key) > 0).all() and count.min() >= 1
    t_of = np.repeat(np.arange(len(count)), count)
    assert (np.diff(k)[t_of[1:] == t_of[:-1]] > 0).all()


def test_sweep_steps_cut_at_each_coupling_to_the_open_step():
    adj = np.zeros((6, 6), dtype=bool)
    adj[1, 0] = True        # block 1 couples back to block 0: a new step
    adj[3, 1] = True        # block 3 couples to block 1 (open step): new step
    adj[5, 0] = True        # block 5 couples to block 0, closed: no cut
    adj[4, 4] = True        # a coupling inside one block never cuts
    assert sc.sweep_steps(adj) == [0, 1, 3, 6]
    assert sc.sweep_steps(np.zeros((3, 3), dtype=bool)) == [0, 3]
    with pytest.raises(ValueError, match="do not cut"):
        sc.sweep_neighbors_from_dense(torch.zeros((2, 4, 8)), steps=[0, 1])


def test_layout_holds_the_int16_limit():
    """Targets and sources up to n_pad - 1 = 32767 fit the int16 layout; a
    larger n_pad is refused."""
    B, nB = 128, 256
    tiles = torch.zeros((nB, 1, B, B))
    col_idx = torch.zeros((nB, 1), dtype=torch.int32)
    col_idx[0, 0], tiles[0, 0, 5, B - 1] = nB - 1, 0.5          # 5 -> 32767
    tiles[nB - 1, 0, B - 1, 5] = 0.5                            # 32767 -> 5
    nbrs = sc.sweep_neighbors_from_tiles(col_idx, tiles)
    assert nbrs.step_ptr.tolist() == [0, nB - 1, nB]
    assert nbrs.tgt.tolist() == [nB * B - 1, 5]
    assert nbrs.src.tolist() == [5, nB * B - 1]
    with pytest.raises(ValueError, match="int16"):
        sc.sweep_neighbors_from_tiles(torch.zeros((nB + 1, 1),
                                                  dtype=torch.int32),
                                      torch.zeros((nB + 1, 1, B, B)))


def test_width_rule_is_a_function_of_replicas_and_sms():
    """The widest CTA at which all R replicas' CTAs fit the SMs' threads at
    once, else the narrowest: wide at the main path's small R, narrow at
    the throughput shape R = 2048 (H100: 132 SMs)."""
    want = {2: 1024, 24: 1024, 64: 1024, 256: 1024, 264: 1024, 265: 512,
            512: 512, 528: 512, 529: 256, 2048: 256}
    for R, width in want.items():
        assert sc.sweep_threads(R, 132) == width, R
    assert sc.sweep_threads(256, 64) == 512 and sc.sweep_threads(1, 1) == 1024
    widths = [sc.sweep_threads(R, 132) for R in range(1, 4096, 7)]
    assert set(widths) <= set(sc.SWEEP_WIDTHS)
    assert all(a >= b for a, b in zip(widths, widths[1:]))


def _inputs(b, R, seed, dtype):
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0).astype(dtype)
    m0[:, ~b.active] = 1.0
    phi0 = (m0 @ b.J_rows.reshape(b.n_pad, b.n_pad) + b.h).astype(dtype)
    return m0, phi0, rng


def _cases(b, R, rng, dtype):
    """(beta_row, mask, beta_spin) per case: both mask shapes, with and
    without beta_spin, beta_row never all equal."""
    beta_row = np.linspace(0.5, 1.25, R).astype(dtype)
    chain_mask = (rng.random((R, b.n_pad)) < 0.7) & b.active
    heated = np.where(rng.random((R, b.n_pad)) < 0.3, 0.01, 1.0).astype(dtype)
    return {
        "activity_mask": (beta_row, b.active[None, :], None),
        "chain_mask": (beta_row, chain_mask, None),
        "chain_mask_beta_spin": (beta_row, chain_mask, heated),
        "activity_mask_beta_spin": (beta_row, b.active[None, :], heated),
    }


CASES = ["activity_mask", "chain_mask", "chain_mask_beta_spin",
         "activity_mask_beta_spin"]


def _t(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", ["streamed", "sparse"])
def test_reference_equals_plain_twins_bit_for_bit(kernel, case):
    """On +-1 couplings phi is integer-valued, so the layout's sweeps and
    the block-by-block twins of K2 (dense rows) and K3 (tiles) agree bit
    for bit from the same random uniforms; the step draws are the block
    draws. The same holds with one step per block."""
    R, T = 5, 8
    _, _, b = _blocked("chimera_2x2")
    nd, nt, col_idx, J_tiles = _nbrs(b)
    m0, phi0, rng = _inputs(b, R, 6, np.float32)
    beta_row, mask, bs = _cases(b, R, rng, np.float32)[case]
    u = torch.as_tensor(rng.random((T, R, b.n_pad)), dtype=torch.float32)
    args = (torch.as_tensor(b.h), torch.as_tensor(m0), torch.as_tensor(phi0),
            None, torch.full((T,), 0.8), torch.as_tensor(beta_row),
            torch.as_tensor(mask), _t(bs))
    if kernel == "streamed":
        nbrs = nd
        plain = sc.colored_sweeps_streamed_reference(
            torch.as_tensor(b.J_rows), *args, num_sweeps=T, uniforms=u)
    else:
        nbrs = nt
        plain = sc.colored_sweeps_sparse_reference(
            torch.as_tensor(col_idx), torch.as_tensor(J_tiles), *args,
            num_sweeps=T, uniforms=u)
    blocks = sc.sweep_neighbors_from_dense(
        torch.as_tensor(b.J_rows), steps=range(b.num_blocks + 1))
    assert len(nbrs.step_ptr) < len(blocks.step_ptr)
    for layout in (nbrs, blocks):
        ref = sc.neighbor_sweeps_reference(layout, *args, num_sweeps=T,
                                           uniforms=u)
        for x, y in zip(ref, plain):
            assert torch.equal(x, y)
    assert (plain.m != torch.as_tensor(m0)).any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", ["streamed", "sparse"])
def test_reference_matches_pallas_interpret_zero_uniforms(kernel, case):
    """The layout's sweeps against the Pallas K2 / K3 in interpret mode
    (whose PRNG returns u = 0), f32; large sweep betas make tanh saturate,
    so the u = 0 dynamics are a nontrivial greedy descent."""
    R, T = 4, 4
    _, _, b = _blocked("chimera_2x2")
    nd, nt, col_idx, J_tiles = _nbrs(b)
    m0, phi0, rng = _inputs(b, R, 2, np.float32)
    beta_row, mask, bs = _cases(b, R, rng, np.float32)[case]
    beta = np.array([20.0, 0.5, 30.0, 1.0], np.float32)
    common = (jnp.asarray(b.h), m0, phi0, 3, beta, beta_row,
              mask.astype(np.float32), bs)
    if kernel == "streamed":
        jr = pallas_colored_sweeps_streamed(
            jnp.asarray(b.J_rows), *common, num_sweeps=T, block_size=8,
            interpret=True)
    else:
        jr = pallas_colored_sweeps_sparse(
            jnp.asarray(col_idx), jnp.asarray(J_tiles), *common,
            num_sweeps=T, block_size=8, interpret=True)
    tr = sc.neighbor_sweeps_reference(
        nd if kernel == "streamed" else nt, torch.as_tensor(b.h),
        torch.as_tensor(m0), torch.as_tensor(phi0), None,
        torch.as_tensor(beta), torch.as_tensor(beta_row),
        torch.as_tensor(mask), _t(bs), num_sweeps=T,
        uniforms=torch.zeros((T, R, b.n_pad)))
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-5)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-5)
    assert (tr.m.numpy() != m0).any()
    frozen = ~np.broadcast_to(mask, m0.shape)
    np.testing.assert_array_equal(tr.m.numpy()[frozen], m0[frozen])


@pytest.mark.parametrize("couplings", ["pm", "gaussian"])
@pytest.mark.parametrize("case", ["per_replica_beta", "beta_spin"])
def test_reference_matches_jax_jacobi_sweeps_f64(case, couplings):
    """In f64 against the JAX XLA Jacobi sweeps with JAX's own uniforms
    injected: m and m_best exact, phi and energies to 1e-10. The XLA sweeps
    take one beta multiplier, so the cases are beta_row alone (as [R, 1])
    and beta_spin with beta_row = 1."""
    R, T = 5, 10
    prob = chimera_graph(2, 2, seed=7, pm=couplings == "pm")
    b = block_problem(prob, block_size=8, groups=color_groups(prob.J),
                      dtype=np.float64)
    nbrs = sc.sweep_neighbors_from_dense(t64(b.J_rows))
    assert nbrs.w.dtype == torch.float64
    m0, phi0, rng = _inputs(b, R, 8, np.float64)
    heated = rng.random(m0.shape) < 0.4
    if case == "per_replica_beta":
        beta_row, bs, mask = np.linspace(0.4, 2.5, R), None, b.active[None]
        j_bs = beta_row[:, None]
    else:
        beta_row, mask = np.ones(R), heated & b.active
        bs = np.where(heated, 1.0 / 20.0, 1.0)
        j_bs = bs
    beta = np.full(T, 1.3)
    key = jax.random.PRNGKey(12)
    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), jnp.asarray(j_bs),
                      jnp.asarray(np.broadcast_to(mask, m0.shape)),
                      num_sweeps=T, within_block="jacobi")
    u = torch.as_tensor(jax_sweep_uniforms(key, T, R, b.n_pad))
    tr = sc.neighbor_sweeps_reference(
        nbrs, t64(b.h), t64(m0), t64(phi0), None, t64(beta), t64(beta_row),
        torch.as_tensor(mask), None if bs is None else t64(bs), num_sweeps=T,
        uniforms=u)
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-10)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-10)
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               atol=1e-10)
    assert (tr.m.numpy() != m0).any()


@pytest.mark.parametrize("name,kernel", [
    ("chimera_16x16", "colored_sweeps_sparse"),
    ("regular3_2048", "colored_sweeps_streamed"),
])
def test_engine_builds_the_layout_once(name, kernel, monkeypatch):
    """SweepEngine builds the layout at setup from its J rows (one step per
    colour class) and hands that one object to every K2 / K3 call."""
    built, seen = [], []
    inner = t_engine.sweep_neighbors_from_dense

    def counting(*a, **k):
        built.append(1)
        return inner(*a, **k)
    monkeypatch.setattr(t_engine, "sweep_neighbors_from_dense", counting)
    wrapped = getattr(t_engine, kernel)

    def recording(*a, **k):
        seen.append(k["nbrs"])
        return wrapped(*a, **k)
    monkeypatch.setattr(t_engine, kernel, recording)
    prob = (t_chimera_graph(16, 16, seed=0) if name == "chimera_16x16"
            else _regular3(2048, seed=1))
    eng = SweepEngine(prob, use_coloring=True, device="cpu")
    assert eng.sweep_kernel == kernel and len(built) == 1
    want = sc.sweep_neighbors_from_dense(eng.J_rows)
    for x, y in zip(eng.sweep_nbrs, want):
        assert x == y if isinstance(x, int) else torch.equal(x, y)
    assert sc.steps_are_independent(eng.sweep_nbrs)
    assert len(eng.sweep_nbrs.step_ptr) - 1 == len(color_groups(prob.J))
    m = np.ones((2, prob.n))
    for _ in range(2):
        eng.run(m, torch.Generator().manual_seed(0), 1, 1.0)
    assert len(built) == 1 and len(seen) == 2
    assert all(n is eng.sweep_nbrs for n in seen)


@pytest.mark.parametrize("name", ["chimera_8x8", "ea2d_32", "uncoloured"])
def test_engine_builds_k1_layout_once_and_none_uncoloured(name, monkeypatch):
    """On a K1 layout (chimera 8x8: 3 steps; ea_2d L = 32: 2) SweepEngine
    builds the neighbour layout once at setup, one step per colour class,
    and hands that object to every K1 call; an uncoloured f32 layout gets
    the sequential route's layout (one-spin blocks) and no K1 call, an
    uncoloured f64 one none and runs the plain sweeps."""
    built, seen = [], []
    inner = t_engine.sweep_neighbors_from_dense

    def counting(*a, **k):
        built.append(1)
        return inner(*a, **k)
    monkeypatch.setattr(t_engine, "sweep_neighbors_from_dense", counting)
    wrapped = t_engine.colored_sweeps

    def recording(*a, **k):
        seen.append(k["nbrs"])
        return wrapped(*a, **k)
    monkeypatch.setattr(t_engine, "colored_sweeps", recording)
    prob, coloring = {
        "chimera_8x8": (t_chimera_graph(8, 8, seed=0), True),
        "ea2d_32": (t_ea_2d(32, seed=1), True),
        "uncoloured": (t_chimera_graph(2, 2, seed=0), False)}[name]
    eng = SweepEngine(prob, use_coloring=coloring, device="cpu")
    m = np.ones((2, prob.n))
    for _ in range(2):
        eng.run(m, torch.Generator().manual_seed(0), 1, 1.0)
    if not coloring:
        assert eng.sweep_kernel == "sequential_sweeps"
        want = sc.sequential_neighbors(eng.J_rows)
        for x, y in zip(eng.sweep_nbrs, want):
            assert x == y if isinstance(x, int) else torch.equal(x, y)
        assert eng.sweep_nbrs.block_size == eng.blocked.block_size
        assert built == [] and seen == []
        eng64 = SweepEngine(prob, dtype=torch.float64, device="cpu")
        assert eng64.sweep_kernel is None and eng64.sweep_nbrs is None
        return
    assert eng.sweep_kernel == "colored_sweeps"
    assert eng.n_pad <= t_engine.K1_MAX_N_PAD and len(built) == 1
    want = sc.sweep_neighbors_from_dense(eng.J_rows)
    for x, y in zip(eng.sweep_nbrs, want):
        assert x == y if isinstance(x, int) else torch.equal(x, y)
    assert sc.steps_are_independent(eng.sweep_nbrs)
    assert len(eng.sweep_nbrs.step_ptr) - 1 == len(color_groups(prob.J))
    assert len(seen) == 2 and all(n is eng.sweep_nbrs for n in seen)


def test_wrappers_check_the_layout_and_the_cpu_path_ignores_it():
    R, T = 3, 3
    _, _, b = _blocked("chimera_2x2")
    nd, nt, col_idx, J_tiles = _nbrs(b)
    m0, phi0, _ = _inputs(b, R, 5, np.float32)
    args = (torch.as_tensor(b.h), torch.as_tensor(m0), torch.as_tensor(phi0))
    rest = (torch.full((T,), 0.9), torch.ones(R), torch.as_tensor(b.active)[None])
    before = (sc.colored_sweeps_streamed.launches,
              sc.colored_sweeps_sparse.launches)
    for nbrs in (nd, None):
        a = sc.colored_sweeps_sparse(
            torch.as_tensor(col_idx), torch.as_tensor(J_tiles), *args,
            torch.Generator().manual_seed(1), *rest, num_sweeps=T, nbrs=nbrs,
            threads=512)
        p = sc.colored_sweeps_sparse_reference(
            torch.as_tensor(col_idx), torch.as_tensor(J_tiles), *args,
            torch.Generator().manual_seed(1), *rest, num_sweeps=T)
        assert all(torch.equal(x, y) for x, y in zip(a, p))
    assert (sc.colored_sweeps_streamed.launches,
            sc.colored_sweeps_sparse.launches) == before
    cpu = torch.device("cpu")
    sc._check_sweep_neighbors(nd, b.n_pad, 8, cpu)
    with pytest.raises(ValueError, match="block_size"):
        sc._check_sweep_neighbors(nd, b.n_pad, 4, cpu)
    with pytest.raises(TypeError, match="int16"):
        sc._check_sweep_neighbors(nd._replace(src=nd.src.int()), b.n_pad, 8,
                                  cpu)
    with pytest.raises(TypeError, match="float32"):
        sc._check_sweep_neighbors(nd._replace(w=nd.w.double()), b.n_pad, 8,
                                  cpu)
    with pytest.raises(ValueError, match="steps"):
        sc._check_sweep_neighbors(nd, 8, 8, cpu)
    with pytest.raises(ValueError, match="n_pad"):
        sc._check_sweep_neighbors(nd, 2 * b.n_pad, 8, cpu)
    with pytest.raises(TypeError, match="SweepNeighbors"):
        sc._check_sweep_neighbors(tuple(nd), b.n_pad, 8, cpu)
    assert sc._shared_bytes_nbr(2048) == 6 * 2048
