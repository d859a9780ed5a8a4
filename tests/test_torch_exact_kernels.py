"""The exact solver's table kernels K6 (f32) and K7 (int8 digit planes): the
plain twins against the JAX package's Pallas kernels, and the wrappers' CPU
routing, checks and ctypes binding.

The CUDA kernels run only on a card; chip_smoke.py holds them against their
twins there. Here the twins are held against `mitm_min_pallas` /
`mitm_min_pallas_i8` in interpret mode, as tests/test_exact.py runs them:
per-row min and argmin bitwise equal on integer-valued inputs (f32 is exact
on integers below 2^24, int32 below 2^31), padded rows and tie-heavy tables
included. On float inputs the twin's matmul sums in another order than
XLA's dot, so min_e agrees to 1e-4 absolute (entries below 40 in magnitude,
a few f32 ulps) and arg_b exactly (no near-ties in these draws).

The kernels read operands packed for the tensor cores (`f32_operands`: the
exact three-way bf16 split of CBT along the depth; `i8_operands`: the digit
planes column-major); `mitm_min_operands_reference` and its K7 twin reduce
those operands in the kernels' association (EB as the accumulator's start,
EA added after the row min) and are held against the Pallas kernels too.
"""

import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.ops import exact_pallas as jx
from nmc_tpu_torch.ops import exact_cuda as ec

CSRC = Path(__file__).resolve().parent.parent / "nmc_tpu_torch" / "csrc"

# (TA, valid rows, a, TB, block_a, block_b)
SHAPES = {"integer": (64, 64, 7, 256, 32, 64),
          "padded": (96, 64, 7, 128, 48, 64),
          "ties": (64, 64, 4, 256, 64, 32),
          # TB below one column tile of either kernel: the packed B pads
          "ragged": (80, 72, 11, 96, 40, 32)}


def _f32_inputs(case, seed=0):
    TA, valid, a, TB, _, _ = SHAPES.get(case, SHAPES["integer"])
    rng = np.random.default_rng(seed)
    SA = np.where(rng.random((TA, a)) < 0.5, -1.0, 1.0)
    if case == "ties":        # few distinct values: most rows tie many times
        CBT = rng.integers(-1, 2, (a, TB))
        EA, EB = rng.integers(-2, 3, TA), rng.integers(0, 2, TB)
    elif case == "float":
        CBT = 3.0 * rng.normal(size=(a, TB))
        EA, EB = 5.0 * rng.normal(size=TA), 5.0 * rng.normal(size=TB)
    else:
        CBT = rng.integers(-50, 51, (a, TB))
        EA, EB = rng.integers(-200, 201, TA), rng.integers(-200, 201, TB)
    EA = EA.astype(np.float64)
    EA[valid:] = np.inf
    return tuple(np.asarray(x, np.float32) for x in (SA, CBT, EA, EB))


def _i8_inputs(case, seed=0):
    TA, valid, a, TB, _, _ = SHAPES.get(case, SHAPES["padded"])
    rng = np.random.default_rng(seed)
    SA = np.where(rng.random((TA, a)) < 0.5, -1, 1).astype(np.int8)
    if case == "ties":
        C = rng.integers(-1, 2, (a, TB))
        EA, EB = rng.integers(-2, 3, TA), rng.integers(0, 2, TB)
    else:                     # 3 digit planes, energies near 2^27
        C = rng.integers(-3_000_000, 3_000_001, (a, TB))
        EA = rng.integers(-2 ** 27, 2 ** 27, TA)
        EB = rng.integers(-2 ** 27, 2 ** 27, TB)
    EA[valid:] = ec.I32_PAD
    return (SA, ec.int8_planes(C), EA.astype(np.int32), EB.astype(np.int32))


def _run_both(jfn, tfn, args, block_a, block_b):
    je, jb = jfn(*map(jnp.asarray, args), block_a=block_a, block_b=block_b,
                 interpret=True)
    te, tb = tfn(*map(torch.as_tensor, args), block_a=block_a,
                 block_b=block_b)
    return (np.asarray(je), np.asarray(jb)), (te.numpy(), tb.numpy())


@pytest.mark.parametrize("case", ["integer", "padded", "ties"])
def test_k6_twin_matches_pallas_interpret_bitwise(case):
    *_, ba, bb = SHAPES[case]
    args = _f32_inputs(case)
    (je, jb), (te, tb) = _run_both(jx.mitm_min_pallas, ec.mitm_min_reference,
                                   args, ba, bb)
    assert te.dtype == np.float32 and tb.dtype == np.int32
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tb, jb)
    if case == "padded":
        assert np.isinf(te[64:]).all() and (tb[64:] == 0).all()
    if case == "ties":        # the lowest index wins every tied row
        T = args[2][:, None] + args[3][None, :] - args[0] @ args[1]
        ties = (T == T.min(axis=1, keepdims=True)).sum(axis=1)
        assert (ties > 1).mean() > 0.5
        np.testing.assert_array_equal(tb, np.argmin(T, axis=1))


def test_k6_twin_matches_pallas_interpret_float():
    args = _f32_inputs("float", seed=3)
    (je, jb), (te, tb) = _run_both(jx.mitm_min_pallas, ec.mitm_min_reference,
                                   args, 32, 64)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("case", ["padded", "ties"])
def test_k7_twin_matches_pallas_interpret_bitwise(case):
    *_, ba, bb = SHAPES[case]
    args = _i8_inputs(case)
    assert args[1].shape[0] == (3 if case == "padded" else 1)
    (je, jb), (te, tb) = _run_both(jx.mitm_min_pallas_i8,
                                   ec.mitm_min_i8_reference, args, ba, bb)
    assert te.dtype == np.int32 and tb.dtype == np.int32
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tb, jb)
    # the wrapped int32 table is the true int64 one here (no wraparound)
    SA, P, EA, EB = (x.astype(np.int64) for x in args)
    C = sum((1 << (8 * k)) * P[k] for k in range(P.shape[0]))
    T = EA[:, None] + EB[None, :] - SA @ C
    np.testing.assert_array_equal(te, T.min(axis=1))
    np.testing.assert_array_equal(tb, np.argmin(T, axis=1))


def test_k7_twin_equals_k6_twin_on_small_integers():
    SA, CBT, EA, EB = _f32_inputs("padded", seed=5)
    e6, b6 = ec.mitm_min_reference(*map(torch.as_tensor, (SA, CBT, EA, EB)),
                                   block_a=48, block_b=64)
    EA_i = np.where(np.isfinite(EA), EA, ec.I32_PAD).astype(np.int32)
    e7, b7 = ec.mitm_min_i8_reference(
        torch.as_tensor(SA.astype(np.int8)),
        torch.as_tensor(ec.int8_planes(CBT)), torch.as_tensor(EA_i),
        torch.as_tensor(EB.astype(np.int32)), block_a=48, block_b=64)
    # valid rows agree; pad rows are +inf at index 0 in K6 and 2^30 + the
    # row's true minimum in K7
    np.testing.assert_array_equal(e7.numpy()[:64], e6.numpy()[:64])
    np.testing.assert_array_equal(b7.numpy()[:64], b6.numpy()[:64])
    assert (e7.numpy()[64:] > (1 << 29)).all()


def test_i8_twin_wraps_like_int32():
    """The top plane's partial 2^24 * dot_3 reaches 2^31: the twin wraps
    in int32 as the Pallas kernel's int32 arithmetic does, and the table it
    reduces is the true one, which lies inside int32."""
    a, TB = 8, 8
    C = np.full((a, TB), 2 ** 28 - 1)       # digits (-1, 0, 0, 16)
    C[:, 1::2] = 2 ** 27
    P = ec.int8_planes(C)
    assert P.shape[0] == 4 and (1 << 24) * int(P[3].sum(axis=0).max()) \
        >= 2 ** 31
    SA = np.ones((4, a), np.int8)
    args = (SA, P, np.zeros(4, np.int32), np.zeros(TB, np.int32))
    (je, jb), (te, tb) = _run_both(jx.mitm_min_pallas_i8,
                                   ec.mitm_min_i8_reference, args, 4, 8)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tb, jb)
    assert (te == -(2 ** 31 - 8)).all() and (tb == 0).all()


def test_int8_planes_equal_to_original(rng):
    C = np.round(rng.normal(size=(9, 33)) * 3e7)   # needs 4 digit planes
    P = ec.int8_planes(C)
    np.testing.assert_array_equal(P, jx.int8_planes(C))
    assert P.dtype == np.int8 and P.shape == (4, 9, 33)
    np.testing.assert_array_equal(ec.int8_planes(np.zeros(3)),
                                  jx.int8_planes(np.zeros(3)))
    assert ec.I32_PAD == jx.I32_PAD and ec.I32_PAD.dtype == np.int32
    with pytest.raises(ValueError, match="integer-valued"):
        ec.int8_planes(np.array([0.5]))


def test_wrappers_on_cpu_run_the_twins_and_check_inputs():
    f32 = tuple(map(torch.as_tensor, _f32_inputs("padded")))
    i8 = tuple(map(torch.as_tensor, _i8_inputs("padded")))
    before = (ec.mitm_min.launches, ec.mitm_min_i8.launches)
    for fn, ref, args in ((ec.mitm_min, ec.mitm_min_reference, f32),
                          (ec.mitm_min_i8, ec.mitm_min_i8_reference, i8)):
        got = fn(*args, block_a=48, block_b=64)
        want = ref(*args, block_a=48, block_b=64)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*(x.to("meta") for x in args), block_a=48, block_b=64)
    assert (ec.mitm_min.launches, ec.mitm_min_i8.launches) == before


@pytest.mark.parametrize("kernel", ["f32", "i8"])
@pytest.mark.parametrize("blocks", [(40, 64), (48, 48)])
def test_block_errors_match_jax(kernel, blocks):
    """TA % block_a and TB % block_b must be 0, with the JAX message."""
    if kernel == "f32":
        args, jfn, tfn = _f32_inputs("padded"), jx.mitm_min_pallas, ec.mitm_min
    else:
        args, jfn, tfn = (_i8_inputs("padded"), jx.mitm_min_pallas_i8,
                          ec.mitm_min_i8)
    ba, bb = blocks
    with pytest.raises(ValueError) as j_err:
        jfn(*map(jnp.asarray, args), block_a=ba, block_b=bb, interpret=True)
    with pytest.raises(ValueError) as t_err:
        tfn(*map(torch.as_tensor, args), block_a=ba, block_b=bb)
    assert str(t_err.value) == str(j_err.value)
    assert "must be multiples of blocks" in str(t_err.value)


def test_planes_contraction_error_matches_jax():
    SA, P, EA, EB = _i8_inputs("padded")
    P = P[:, :-1]
    with pytest.raises(ValueError) as j_err:
        jx.mitm_min_pallas_i8(*map(jnp.asarray, (SA, P, EA, EB)),
                              block_a=48, block_b=64, interpret=True)
    with pytest.raises(ValueError) as t_err:
        ec.mitm_min_i8(*map(torch.as_tensor, (SA, P, EA, EB)), block_a=48,
                       block_b=64)
    assert str(t_err.value) == str(j_err.value)
    assert "contraction dim" in str(t_err.value)


@pytest.mark.parametrize("fn", ["mitm_min_f32", "mitm_min_i8"])
def test_ctypes_binding_matches_each_entry_point(fn):
    """Every parameter of each C entry point gets its ctypes type: pointers
    as c_void_p (a c_int would cut a 64-bit pointer), ints as c_int."""
    src = (CSRC / "exact_mitm.cu").read_text()
    sig = re.search(rf"int {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    fake = types.SimpleNamespace(**{fn: types.SimpleNamespace()})
    argtypes = getattr(ec._bind(fake, fn), fn).argtypes
    assert len(argtypes) == len(params)
    for p, t in zip(params, argtypes):
        expected = ctypes.c_void_p if "*" in p else ctypes.c_int
        assert t is expected, p


# ---- the kernels' packed operands -------------------------------------------

def _split_sum(x):
    parts = ec.split_bf16(torch.as_tensor(x))
    assert all(p.dtype == torch.bfloat16 for p in parts)
    return [p.double().numpy() for p in parts]


@pytest.mark.parametrize("kind", ["float", "integer"])
def test_split_bf16_parts_sum_exactly(kind):
    """hi + mid + lo == x bit for bit, every part with x's sign, and
    |hi| + |mid| + |lo| == |x|: on f32 values over many binades and on
    integers up to 2^24 in magnitude."""
    rng = np.random.default_rng(11)
    if kind == "float":
        x = (rng.normal(size=4096) * 2.0 ** rng.integers(-30, 30, 4096))
    else:
        x = rng.integers(-(1 << 24), (1 << 24) + 1, 4096).astype(np.float64)
        x[:4] = [1 << 24, -(1 << 24), (1 << 24) - 1, 0]
    x = x.astype(np.float32)
    hi, mid, lo = _split_sum(x)
    np.testing.assert_array_equal(hi + mid + lo, x.astype(np.float64))
    for p in (hi, mid, lo):
        assert (p * x >= 0).all()
    np.testing.assert_array_equal(np.abs(hi) + np.abs(mid) + np.abs(lo),
                                  np.abs(x.astype(np.float64)))
    assert (np.abs(mid) < np.abs(hi) + (hi == 0)).all()


@pytest.mark.parametrize("case", ["integer", "padded", "ties", "ragged",
                                  "float"])
def test_f32_operands_layout(case):
    """K6's packed product is -SA . CBT exactly; the depth is 3a rounded up
    to 32, TB up to a whole column tile, EB padded with +inf."""
    SA, CBT, EA, EB = map(torch.as_tensor, _f32_inputs(case))
    TA, a = SA.shape
    TB = EB.shape[0]
    A, B, EBp = ec.f32_operands(SA, CBT, EB)
    kd = 32 * -(-3 * a // 32)
    TBp = -(-TB // ec.TILE_B_F32) * ec.TILE_B_F32
    assert A.shape == (TA, kd) and B.shape == (TBp, kd)
    assert A.dtype == B.dtype == torch.bfloat16 and EBp.shape == (TBp,)
    np.testing.assert_array_equal(
        (A.double() @ B.double().T)[:, :TB].numpy(),
        -(SA.double() @ CBT.double()).numpy())
    assert (A[:, 3 * a:] == 0).all() and (B[:, 3 * a:] == 0).all()
    assert (B[TB:] == 0).all() and torch.isinf(EBp[TB:]).all()
    assert torch.equal(EBp[:TB], EB)


@pytest.mark.parametrize("case", ["padded", "ties", "ragged"])
def test_i8_operands_layout(case):
    SA, P, EA, EB = map(torch.as_tensor, _i8_inputs(case))
    TA, a = SA.shape
    K, _, TB = P.shape
    A, B, EBp = ec.i8_operands(SA, P, EB)
    TBp = -(-TB // ec.TILE_B_I8) * ec.TILE_B_I8
    assert A.shape == (TA, 32) and B.shape == (TBp, K, 32)
    assert A.dtype == B.dtype == torch.int8 and EBp.dtype == torch.int32
    assert torch.equal(A[:, :a], -SA) and (A[:, a:] == 0).all()
    assert torch.equal(B[:TB, :, :a], P.permute(2, 0, 1))
    assert (B[TB:] == 0).all() and (B[:, :, a:] == 0).all()
    assert (EBp[TB:] == torch.iinfo(torch.int32).max).all()
    assert torch.equal(EBp[:TB], EB)


def _packed_k6(args):
    SA, CBT, EA, EB = map(torch.as_tensor, args)
    A, B, EBp = ec.f32_operands(SA, CBT, EB)
    return ec.mitm_min_operands_reference(A, B, EA, EBp)


def _packed_k7(args):
    SA, P, EA, EB = map(torch.as_tensor, args)
    A, B, EBp = ec.i8_operands(SA, P, EB)
    return ec.mitm_min_i8_operands_reference(A, B, EA, EBp)


@pytest.mark.parametrize("case", ["integer", "padded", "ties", "ragged"])
def test_k6_packed_operands_match_pallas_interpret_bitwise(case):
    """The kernel's association over its packed operands (EB + A . B, the
    row min, EA after it) equals the Pallas kernel bit for bit on integer
    couplings, pad rows (+inf, 0) and tied rows included."""
    *_, ba, bb = SHAPES[case]
    args = _f32_inputs(case, seed=4)
    je, jb = jx.mitm_min_pallas(*map(jnp.asarray, args), block_a=ba,
                                block_b=bb, interpret=True)
    te, tb = _packed_k6(args)
    assert te.dtype == torch.float32 and tb.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    valid = SHAPES[case][1]
    assert np.isinf(te.numpy()[valid:]).all()
    assert (tb.numpy()[valid:] == 0).all()


def test_k6_packed_operands_match_pallas_interpret_float():
    """Float couplings: within 128 * 2^-24 * the entries' magnitude bound
    (the tolerance chip_smoke.py holds the kernel to), argmins equal (no
    near-ties in this draw)."""
    args = _f32_inputs("float", seed=3)
    SA, CBT, EA, EB = args
    je, jb = jx.mitm_min_pallas(*map(jnp.asarray, args), block_a=32,
                                block_b=64, interpret=True)
    te, tb = _packed_k6(args)
    bound = (np.abs(EA).max() + np.abs(EB).max()
             + np.abs(CBT).sum(axis=0).max())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=128 * 2.0 ** -24 * bound)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("case", ["padded", "ties", "ragged"])
def test_k7_packed_operands_match_pallas_interpret_bitwise(case):
    """K7's association (plane 0 from EB, planes recombined in wrapping
    uint32, EA after the row min) equals the Pallas kernel bit for bit, pad
    rows included: 3 digit planes on "padded", ties on "ties", a ragged
    TB on "ragged"."""
    *_, ba, bb = SHAPES[case]
    args = _i8_inputs(case, seed=6)
    assert args[1].shape[0] == (1 if case == "ties" else 3)
    je, jb = jx.mitm_min_pallas_i8(*map(jnp.asarray, args), block_a=ba,
                                   block_b=bb, interpret=True)
    te, tb = _packed_k7(args)
    assert te.dtype == torch.int32 and tb.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    valid = SHAPES[case][1]
    assert (te.numpy()[valid:] > (1 << 29)).all()


def test_k7_packed_equals_k6_packed_on_small_integers():
    """Where both apply (integers below 2^24) the two associations agree on
    every valid row, and K6's pad rows are (+inf, 0)."""
    SA, CBT, EA, EB = _f32_inputs("ragged", seed=8)
    e6, b6 = _packed_k6((SA, CBT, EA, EB))
    EA_i = np.where(np.isfinite(EA), EA, ec.I32_PAD).astype(np.int32)
    e7, b7 = _packed_k7((SA.astype(np.int8), ec.int8_planes(CBT), EA_i,
                         EB.astype(np.int32)))
    valid = SHAPES["ragged"][1]
    np.testing.assert_array_equal(e7.numpy()[:valid],
                                  e6.numpy()[:valid].astype(np.int32))
    np.testing.assert_array_equal(b7.numpy()[:valid], b6.numpy()[:valid])
    assert np.isinf(e6.numpy()[valid:]).all() and (b6[valid:] == 0).all()
