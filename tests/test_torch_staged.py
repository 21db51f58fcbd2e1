"""The port's staged large-robot pipeline (``ops/kernels/staged.py``) and
its dense factor helpers (``ops/kernels/contact_fused.py``) on CPU tensors
— their plain stages — against the JAX package in float64:

* the ``_chol_*`` helpers against the JAX ones on a CRBA mass matrix;
* each stage and the two pipelines against the JAX ``staged.py`` in
  interpret mode, forced on small robots (``block_b=4``, 5 states): K1, K2′
  with and without a right-hand side, ∂ID and ∇FD on ``barm`` and ``dpend``
  at a column block that leaves a ragged last block on ``barm``;
* the slice as a whole on Atlas (n = 28, a forest of three trees), through
  the public API, against the float64 golden model. Compiling the JAX
  ``bl`` path at n = 28 is too slow for this suite on one core, so the
  Atlas comparison is with the golden model; the JAX comparison of the
  same staged structure runs on the forced small robots above.

Tolerance 1e-10·max(1, |ref|) per element against JAX (the same sums in
the same order), 1e-9·max(1, |ref|) per state against the golden model.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup, random_state
from gridcodegenerator_tpu.ops import blops as jb
from gridcodegenerator_tpu.ops.kernels import contact_fused as jcf
from gridcodegenerator_tpu.ops.kernels import staged as js
from gridcodegenerator_tpu_torch.ops.kernels import _build
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as tcf
from gridcodegenerator_tpu_torch.ops.kernels import fused as tf
from gridcodegenerator_tpu_torch.ops.kernels import staged as ts

torch.set_num_threads(1)

B = 5
# the K5 column block forced on each small robot: barm (n = 9) gets blocks
# of 5 and 4 columns, dpend (n = 2) one block of 2. Each block is one
# interpret-mode Pallas compile on the JAX side, so barm takes two blocks,
# not the five of cb = 2, to keep this file within its time.
FORCED_CB = {"barm": 5, "dpend": 2}


def assert_close(got, ref, tol=1e-10):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


@functools.cache
def _case(name):
    desc, _, jm = get_setup(name)
    q, qd, u = (x.T.copy() for x in random_state(desc.n, seed=17, batch=(B,)))
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    return jm, tm, q, qd, u


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# ------------------------------------------------------ dense factor helpers
def test_chol_helpers_match_jax():
    """Factor, symmetric inverse and multi-rhs solve of the branched arm's
    CRBA mass matrix (ancestor-sparse: the sibling arms do not couple)."""
    jm, tm, q, _, u = _case("barm")
    n = tm.n
    Mj = jb.crba_bl(jm, jb.joint_transforms_bl(jm, jnp.asarray(q)))
    Mt = [[None if e is None else torch.from_numpy(np.array(e)) for e in row]
          for row in Mj]
    cols_j = jcf._chol_factor_act(Mj, n)
    cols_t = tcf._chol_factor_act(Mt, n)
    for g_, r_ in zip(cols_t, cols_j):
        assert_close(g_, r_)
    assert_close(tcf._chol_minv_sym(cols_t, n), jcf._chol_minv_sym(cols_j, n))
    rhs = np.stack([u, 2.0 * u[::-1]], axis=1)                    # (n, 2, B)
    assert_close(tcf._chol_solve_act(cols_t, torch.from_numpy(rhs)),
                 jcf._chol_solve_act(cols_j, jnp.asarray(rhs)))


# ------------------------------------------------- stages, in interpret mode
@pytest.mark.parametrize("name", list(FORCED_CB))
def test_bias_and_v_staged(name):
    jm, tm, q, qd, _ = _case(name)
    ref = js.bias_and_v_staged(jm, *_j(q, qd), -9.81, 4, True)
    for g_, r_ in zip(ts.bias_and_v_staged(tm, *_t(q, qd)), ref):
        assert_close(g_, r_)


@pytest.mark.parametrize("rhs", [False, True])
@pytest.mark.parametrize("name", list(FORCED_CB))
def test_minv_qdd_dense_staged(name, rhs):
    jm, tm, q, _, u = _case(name)
    extra = (u,) if rhs else ()
    ref = js.minv_qdd_dense_staged(jm, *_j(q, *extra), block_b=4,
                                   interpret=True)
    got = ts.minv_qdd_dense_staged(tm, *_t(q, *extra))
    assert len(got) == len(ref) == 1 + rhs
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


def test_id_grad_staged():
    jm, tm, q, qd, u = _case("dpend")
    cb = FORCED_CB["dpend"]
    ref = js.id_grad_staged(jm, *_j(q, qd, u), block_b=4, cb=cb,
                            interpret=True)
    for g_, r_ in zip(ts.id_grad_staged(tm, *_t(q, qd, u), cb=cb), ref):
        assert_close(g_, r_)


@pytest.mark.parametrize("name", list(FORCED_CB))
def test_fd_grad_staged(name):
    """K1, K2′, K4 and K5 with the fused −M⁻¹·∂c finish over each block's
    nonzero rows — on the branched arm a block spans both sibling arms and
    the last block is ragged."""
    jm, tm, q, qd, u = _case(name)
    cb = FORCED_CB[name]
    ref = js.fd_grad_staged(jm, *_j(q, qd, u), block_b=4, cb=cb,
                            interpret=True)
    for g_, r_ in zip(ts.fd_grad_staged(tm, *_t(q, qd, u), cb=cb), ref):
        assert_close(g_, r_)


def test_id_grad_staged_branched_blocks():
    """∂ID's vaf sweep and K5 without the finish on the branched arm — a
    block spanning both sibling arms, then a ragged one — against the JAX
    staged ∂ID in interpret mode and against the unblocked ∂ID of the
    single-kernel route."""
    jm, tm, q, qd, u = _case("barm")
    cb = FORCED_CB["barm"]
    got = ts.id_grad_staged(tm, *_t(q, qd, u), cb=cb)
    ref = js.id_grad_staged(jm, *_j(q, qd, u), block_b=4, cb=cb,
                            interpret=True)
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)
    for g_, r_ in zip(got, tf.id_grad_plain(tm, *_t(q, qd, u))):
        assert_close(g_, r_.numpy())


def test_stage_compositions():
    """K4 after K1/K2′ is the ∂ID vaf sweep at the K2′ q̈, and the finish
    is −M⁻¹ times the K5 blocks without it."""
    _, tm, q, qd, u = _case("barm")
    tq, tqd, tu = _t(q, qd, u)
    c, v = ts.bias_and_v_staged(tm, tq, tqd)
    Minv, qdd = ts.minv_qdd_dense_staged(tm, tq, tu - c)
    a, f = ts.af_staged(tm, tq, tqd, qdd, v)
    v2, a2, f2 = ts.vaf_staged(tm, tq, tqd, qdd)
    for g_, r_ in ((v, v2), (a, a2), (f, f2)):
        assert_close(g_, r_.numpy())
    cb = FORCED_CB["barm"]
    fin = ts.grad_cols_staged(tm, tq, tqd, v, a, f, cb=cb, Minv=Minv)
    raw = ts.grad_cols_staged(tm, tq, tqd, v, a, f, cb=cb)
    for g_, r_ in zip(fin, raw):
        ref = -torch.einsum("ikb,kjb->ijb", Minv, r_)
        assert_close(g_, ref.numpy())


def test_col_block_bounds():
    _, tm, q, qd, u = _case("dpend")
    with pytest.raises(ValueError, match="cb must be in"):
        ts.id_grad_staged(tm, *_t(q, qd, u),
                          cb=_build.default_col_block(tm.n) + 1)


# ------------------------------------------------------ the Atlas slice
@functools.cache
def _atlas():
    desc, gold, _ = get_setup("atlas")
    q, qd, u = random_state(desc.n, seed=29, batch=(3,))
    tm = gt.load_robot(ROBOTS["atlas"], dtype=torch.float64, device="cpu")
    return gold, tm, q, qd, u


ATLAS_CALLS = {
    "forward_dynamics_gradient": (3, lambda g, q, qd, u: g.fd_grad(q, qd, u)),
    "inverse_dynamics_gradient": (
        3, lambda g, q, qd, u: np.hstack(g.rnea_grad(q, qd, u))),
    "direct_minv": (1, lambda g, q, qd, u: g.minv(q, True)),
    "forward_dynamics": (3, lambda g, q, qd, u: g.fd(q, qd, u)),
    "inverse_dynamics": (3, lambda g, q, qd, u: g.rnea(q, qd, u)[0]),
    "bias_force": (2, lambda g, q, qd, u: g.rnea(q, qd, None)[0]),
}


@pytest.mark.parametrize("fam", list(ATLAS_CALLS))
def test_atlas_slice_matches_golden(fam):
    """Atlas (n = 28) through the public API on CPU tensors: ∇FD, ∂ID and
    M⁻¹ take the staged route on its plain stages, FD the ABA, RNEA its
    single-kernel plain version."""
    gold, tm, q, qd, u = _atlas()
    k, ref_fn = ATLAS_CALLS[fam]
    got = getattr(gt, fam)(tm, *_t(q, qd, u)[:k]).numpy()
    assert got.shape[0] == 3
    for s in range(3):
        ref = ref_fn(gold, q[s], qd[s], u[s])
        err = np.abs(got[s] - ref).max()
        assert err <= 1e-9 * max(1.0, np.abs(ref).max()), f"{fam}: {err:.3e}"


def test_atlas_routes_through_staged(monkeypatch):
    """Past MAX_KERNEL_JOINTS (``_build.dense_grads`` false) the ∇FD, ∂ID
    and M⁻¹ wrappers run the staged structure — here on its plain stages —
    and never the single-kernel plain versions."""
    _, tm, q, qd, u = _atlas()
    assert not _build.dense_grads(tm.n)
    called = []
    for name in ("bias_and_v_plain", "minv_qdd_dense_plain", "af_plain",
                 "vaf_plain", "grad_cols_plain"):
        real = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _r=real, _n=name, **k: (
            called.append(_n), _r(*a, **k))[1])
    for name in ("fd_grad_plain", "id_grad_plain", "minv_plain"):
        monkeypatch.setattr(tf, name, lambda *a, **k: pytest.fail(
            "single-kernel plain version reached at n = 28"))
    tq, tqd, tu = (torch.from_numpy(x.T.copy()) for x in (q, qd, u))
    tf.fd_grad_fused(tm, tq, tqd, tu)
    assert called == ["bias_and_v_plain", "minv_qdd_dense_plain", "af_plain",
                      "grad_cols_plain"]
    called.clear()
    tf.id_grad_fused(tm, tq, tqd, tu)
    tf.minv_fused(tm, tq)
    assert called == ["vaf_plain", "grad_cols_plain", "minv_qdd_dense_plain"]
