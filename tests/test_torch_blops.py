"""Each plain function of the port's ``ops/blops.py`` against the JAX
package's ``ops/blops.py`` in float64, on the same numpy inputs.

Every port function is fed the JAX pipeline's own intermediates (converted
to torch), so a disagreement points at that one function. Tolerance:
1e-10·max(1, |ref|) per element; the two run the same sums in the same
order, so they agree to round-off.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup, random_state
from gridcodegenerator_tpu.ops import blops as jb
from gridcodegenerator_tpu_torch.ops import blops as tb

torch.set_num_threads(1)

# a serial chain with prismatic joints, and sibling arms under a moving torso
BL_ROBOTS = ["chain5p", "barm"]
B = 5


def assert_close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.broadcast_to(np.asarray(ref), got.shape)
    err = np.abs(got - ref)
    bound = 1e-10 * np.maximum(1.0, np.abs(ref))
    assert np.all(err <= bound), f"max err {err.max():.3e}"


def T(x):
    return torch.from_numpy(np.array(x))


def Tl(xs):
    return [T(x) for x in xs]


@functools.cache
def _inputs(name):
    desc = get_setup(name)[0]
    q, qd, u = random_state(desc.n, seed=71, batch=(B,))
    return q.T.copy(), qd.T.copy(), u.T.copy()     # batch-last (n, B)


@functools.cache
def _tmodel(name):
    return gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")


@functools.cache
def _ref(name, key):
    """The JAX pipeline's stages, computed once per process and robot."""
    m = get_setup(name)[2]
    q, qd, u = (jnp.asarray(x) for x in _inputs(name))
    if key == "X":
        return jb.joint_transforms_bl(m, q)
    if key == "fwd":                       # with q̈ = u
        return jb.rnea_fwd_bl(m, _ref(name, "X"), qd, u)
    if key == "bwd":
        return jb.rnea_bwd_bl(m, _ref(name, "X"), _ref(name, "fwd")[2], qd,
                              u)
    if key == "rnea_bl":
        return jb.rnea_bl(m, q, qd, u)
    if key == "minv":
        return jb.minv_bl(m, _ref(name, "X"))
    if key == "dense":
        return jb.densify_rows(_ref(name, "minv")[0])
    if key == "matvecN":
        return jb.matvecN(_ref(name, "dense"), u)
    if key == "fd_bl":
        return jb.fd_bl(m, q, qd, u)
    if key == "grad_inner":                # at q̈ = u, both sides
        v, a, f = _ref(name, "fwd")
        _, fb = jb.rnea_bwd_bl(m, _ref(name, "X"), f, None)
        return jb.rnea_grad_inner_bl(m, _ref(name, "X"), qd, v, a, fb), fb
    if key == "matmatN":
        return jb.matmatN(_ref(name, "dense"),
                          _ref(name, "grad_inner")[0]["q"], negate=True)
    if key == "fd_grad_bl":
        return jb.fd_grad_bl(m, q, qd, u)
    raise KeyError(key)


@pytest.fixture(params=BL_ROBOTS)
def name(request):
    return request.param


def test_joint_transforms_bl(name):
    q, _, _ = _inputs(name)
    got = tb.joint_transforms_bl(_tmodel(name), T(q))
    for g_, r_ in zip(got, _ref(name, "X")):
        assert_close(g_, r_)


def test_rnea_fwd_bl(name):
    _, qd, u = _inputs(name)
    X = Tl(_ref(name, "X"))
    got = tb.rnea_fwd_bl(_tmodel(name), X, T(qd), T(u))
    for g_list, r_list in zip(got, _ref(name, "fwd")):
        for g_, r_ in zip(g_list, r_list):
            assert_close(g_, r_)
    # the second sweep of ∇FD: v reused, a and f recomputed
    v = Tl(_ref(name, "fwd")[0])
    _, got_a, _ = tb.rnea_fwd_bl(_tmodel(name), X, T(qd), T(u),
                                 v_known=v)
    for g_, r_ in zip(got_a, _ref(name, "fwd")[1]):
        assert_close(g_, r_)


def test_rnea_bwd_bl(name):
    _, qd, u = _inputs(name)
    c, f = tb.rnea_bwd_bl(_tmodel(name), Tl(_ref(name, "X")),
                          Tl(_ref(name, "fwd")[2]), T(qd), T(u))
    rc, rf = _ref(name, "bwd")
    assert_close(c, rc)
    for g_, r_ in zip(f, rf):
        assert_close(g_, r_)


def test_rnea_bl(name):
    q, qd, u = _inputs(name)
    got = tb.rnea_bl(_tmodel(name), T(q), T(qd), T(u))
    ref = _ref(name, "rnea_bl")
    assert_close(got[0], ref[0])
    for k in (1, 2, 3):
        for g_, r_ in zip(got[k], ref[k]):
            assert_close(g_, r_)


def test_minv_bl(name):
    rows, U, Dinv = tb.minv_bl(_tmodel(name), Tl(_ref(name, "X")))
    r_rows, r_U, r_Dinv = _ref(name, "minv")
    for got, ref in ((rows, r_rows), (U, r_U), (Dinv, r_Dinv)):
        for g_, r_ in zip(got, ref):
            assert_close(torch.broadcast_to(g_, np.shape(r_)), r_)


def test_densify_rows(name):
    got = tb.densify_rows(Tl(_ref(name, "minv")[0]))
    assert_close(got, _ref(name, "dense"))


def test_matvecN(name):
    _, _, u = _inputs(name)
    assert_close(tb.matvecN(T(_ref(name, "dense")), T(u)),
                 _ref(name, "matvecN"))


def test_fd_bl(name):
    q, qd, u = _inputs(name)
    assert_close(tb.fd_bl(_tmodel(name), T(q), T(qd), T(u)),
                 _ref(name, "fd_bl"))


@pytest.mark.parametrize("side", ["q", "qd"])
def test_rnea_grad_inner_bl(name, side):
    _, qd, _ = _inputs(name)
    v, a, _ = (Tl(x) for x in _ref(name, "fwd"))
    ref, fb = _ref(name, "grad_inner")
    got = tb.rnea_grad_inner_bl(_tmodel(name), Tl(_ref(name, "X")), T(qd),
                                v, a, Tl(fb), sides=(side,))
    assert list(got) == [side]
    assert_close(got[side], ref[side])


def test_matmatN(name):
    got = tb.matmatN(T(_ref(name, "dense")),
                     T(_ref(name, "grad_inner")[0]["q"]), negate=True)
    assert_close(got, _ref(name, "matmatN"))


def test_fd_grad_bl(name):
    q, qd, u = _inputs(name)
    got = tb.fd_grad_bl(_tmodel(name), T(q), T(qd), T(u))
    for g_, r_ in zip(got, _ref(name, "fd_grad_bl")):
        assert_close(g_, r_)


# ------------------------------------------- column-blocked (staged) bodies
COLS_ROBOTS = ["barm", "dpend", "chain5p"]


@pytest.mark.parametrize("rname", COLS_ROBOTS)
def test_crba_bl(rname):
    """The mass matrix as an ancestor-sparse list of lists: the same
    entries, and ``None`` exactly where the JAX one has it."""
    got = tb.crba_bl(_tmodel(rname), Tl(_ref(rname, "X")))
    ref = jb.crba_bl(get_setup(rname)[2], _ref(rname, "X"))
    for g_row, r_row in zip(got, ref):
        for g_, r_ in zip(g_row, r_row):
            assert (g_ is None) == (r_ is None)
            if r_ is not None:
                assert_close(torch.broadcast_to(g_, np.shape(r_)), r_)


@functools.cache
def _cols_ref(rname, c0, w):
    """The JAX row lists of one block (its stacked form is the same rows,
    zeros for ``None``)."""
    v, a, _ = _ref(rname, "fwd")
    _, fb = _ref(rname, "grad_inner")
    return jb.rnea_grad_cols_bl(get_setup(rname)[2], _ref(rname, "X"),
                                jnp.asarray(_inputs(rname)[1]), v, a, fb,
                                c0=c0, cb=w, as_rows=True)


# blocks start at c0 ∈ {0, 1, 4} where the robot has that many joints
BLOCKS = [(r, c0) for r in COLS_ROBOTS for c0 in (0, 1, 4)
          if c0 < get_setup(r)[0].n]


@pytest.mark.parametrize("as_rows", [False, True])
@pytest.mark.parametrize("rname,c0", BLOCKS)
def test_rnea_grad_cols_bl(rname, c0, as_rows):
    """Ragged column blocks (width 3, the last one cut at n), both sides,
    stacked or as the row list whose ``None`` rows the staged finish
    skips."""
    w = min(3, _tmodel(rname).n - c0)
    _, qd, _ = _inputs(rname)
    v, a, _ = (Tl(x) for x in _ref(rname, "fwd"))
    _, fb = _ref(rname, "grad_inner")
    got = tb.rnea_grad_cols_bl(_tmodel(rname), Tl(_ref(rname, "X")), T(qd),
                               v, a, Tl(fb), c0=c0, cb=w, as_rows=as_rows)
    ref = _cols_ref(rname, c0, w)
    for side in ("q", "qd"):
        if not as_rows:
            assert_close(got[side], np.stack(
                [np.zeros((w, B)) if r is None else r for r in ref[side]]))
            continue
        for g_, r_ in zip(got[side], ref[side]):
            assert (g_ is None) == (r_ is None)
            if r_ is not None:
                assert_close(g_, r_)


# ------------------------------------------------------------- primitives
def _rand(*shape, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape)


ARGS = {
    "X": _rand(6, 6, B, seed=1), "v": _rand(6, B, seed=2),
    "D": _rand(6, 4, B, seed=3), "a3": _rand(3, B, seed=4),
    "b3": _rand(3, B, seed=5), "w": _rand(6, B, seed=6),
}
CALLS = {
    "matvec6": ("X", "v"), "matvec6_T": ("X", "v"), "matmat6": ("X", "D"),
    "matmat6_T": ("X", "D"), "cross3_bl": ("a3", "b3"),
    "crm_apply_bl": ("v", "w"), "crf_apply_bl": ("v", "w"),
    "crm_cols_left": ("v", "D"), "crf_cols_right": ("D", "v"),
    "crf_cols_left": ("v", "D"),
}


@pytest.mark.parametrize("fn", list(CALLS))
def test_primitive(fn):
    args = [ARGS[k] for k in CALLS[fn]]
    ref = getattr(jb, fn)(*(jnp.asarray(x) for x in args))
    got = getattr(tb, fn)(*(T(x) for x in args))
    assert_close(got, ref)
