"""The staged pipeline for large robots (Atlas-scale) and its plain stages.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/staged.py``
(fixed base, default route). The single-thread ∇FD, ∂ID and M⁻¹ kernels keep
O(n²) values a state; past ``MAX_KERNEL_JOINTS`` joints the work is cut into
kernels whose per-thread arrays grow as n·cb, with small per-state tensors
staged through device memory between them and X(q) recomputed in each:

  K1   q, q̇           → c, v        bias RNEA (v does not depend on q̈)
  K2′  q, u − c        → M⁻¹, q̈     CRBA, active-region Cholesky, L⁻ᵀL⁻¹
  K4   q, q̇, q̈, v     → a, f        the second sweep at the true q̈
  K5   q, q̇, v, a, f[, M⁻¹] → ∂c or −M⁻¹·∂c, column block by column block,
       both sides, every block in one launch (a 2-D grid)

∇FD is K1, K2′, K4, K5 with the fused finish (four launches); ∂ID is the
vaf sweep and K5 without it (two); ``direct_minv`` is K2′ alone. Each stage
wrapper runs its plain version (``*_plain``, built on :mod:`..blops` and
:mod:`.contact_fused`) on CPU tensors and its kernel (``csrc/staged.cu``)
on CUDA tensors, or raises; there is no fallback between the two.

``cb`` is the K5 column-block width. ``None`` takes the width the kernels
are compiled for (``_build.default_col_block``); a smaller one forces
narrower blocks (the tests use it to put a ragged block on a small robot).
"""

from __future__ import annotations

import torch

from ...models.robot import RobotModel
from .. import blops
from . import _build
from .contact_fused import _chol_factor_act, _chol_minv_sym
from ._launch import (check, check_staged, empty, launch, on_cpu,
                      ptr)


def _as_list(stacked, n):
    """(6, n, B) staged tensor → per-joint list of (6, B)."""
    return [stacked[:, i] for i in range(n)]


def _col_block(model: RobotModel, cb):
    full = _build.default_col_block(model.n)
    if cb is None:
        return full
    if not 1 <= cb <= full:
        raise ValueError(f"cb must be in [1, {full}] for robot "
                         f"'{model.name}' (n={model.n}), got {cb}")
    return cb


def _blocks(n, cb):
    return [(c0, min(cb, n - c0)) for c0 in range(0, n, cb)]


# --------------------------------------------------------------------------
# plain stages (any device)
# --------------------------------------------------------------------------
def bias_and_v_plain(model: RobotModel, q, qd, gravity=-9.81):
    X = blops.joint_transforms_bl(model, q)
    v, _, f0 = blops.rnea_fwd_bl(model, X, qd, None, gravity)
    c, _ = blops.rnea_bwd_bl(model, X, f0, qd)
    return c, torch.stack(v, dim=1)


def minv_qdd_dense_plain(model: RobotModel, q, rhs=None):
    n = model.n
    X = blops.joint_transforms_bl(model, q)
    Minv = _chol_minv_sym(_chol_factor_act(blops.crba_bl(model, X), n), n)
    if rhs is None:
        return (Minv,)
    return Minv, sum(Minv[:, j] * rhs[j:j + 1] for j in range(n))


def af_plain(model: RobotModel, q, qd, qdd, v, gravity=-9.81):
    X = blops.joint_transforms_bl(model, q)
    _, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity,
                                v_known=_as_list(v, model.n))
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    return torch.stack(a, dim=1), torch.stack(f, dim=1)


def vaf_plain(model: RobotModel, q, qd, qdd, gravity=-9.81):
    X = blops.joint_transforms_bl(model, q)
    v, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity)
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    return (torch.stack(v, dim=1), torch.stack(a, dim=1),
            torch.stack(f, dim=1))


def grad_cols_plain(model: RobotModel, q, qd, v, a, f, gravity=-9.81,
                    cb=None, Minv=None):
    """K5 over every column block: (∂c/∂q, ∂c/∂q̇), or with ``Minv`` the
    fused finish (−M⁻¹·∂c over each block's nonzero rows), each (n,n,B)."""
    n = model.n
    cb = _col_block(model, cb)
    X = blops.joint_transforms_bl(model, q)
    vl, al, fl = (_as_list(t, n) for t in (v, a, f))
    outs = {"q": [], "qd": []}
    for c0, w in _blocks(n, cb):
        for side in ("q", "qd"):
            if Minv is None:
                blk = blops.rnea_grad_cols_bl(model, X, qd, vl, al, fl,
                                              gravity, c0=c0, cb=w,
                                              sides=(side,))[side]
            else:
                rows = blops.rnea_grad_cols_bl(
                    model, X, qd, vl, al, fl, gravity, c0=c0, cb=w,
                    sides=(side,), as_rows=True)[side]
                acc = None
                for i, r in enumerate(rows):
                    if r is None:
                        continue
                    term = Minv[:, i][:, None] * r[None]
                    acc = term if acc is None else acc + term
                blk = -acc
            outs[side].append(blk)
    return torch.cat(outs["q"], dim=1), torch.cat(outs["qd"], dim=1)


def id_grad_plain(model: RobotModel, q, qd, qdd, gravity=-9.81, cb=None):
    v, a, f = vaf_plain(model, q, qd, qdd, gravity)
    return grad_cols_plain(model, q, qd, v, a, f, gravity, cb=cb)


def fd_grad_plain(model: RobotModel, q, qd, u, gravity=-9.81, cb=None):
    c, v = bias_and_v_plain(model, q, qd, gravity)
    Minv, qdd = minv_qdd_dense_plain(model, q, u - c)
    a, f = af_plain(model, q, qd, qdd, v, gravity)
    return grad_cols_plain(model, q, qd, v, a, f, gravity, cb=cb, Minv=Minv)


# --------------------------------------------------------------------------
# stage wrappers: the plain stage on CPU tensors, the kernel on CUDA tensors
# --------------------------------------------------------------------------
def bias_and_v_staged(model: RobotModel, q, qd, gravity=-9.81):
    """K1: c (n, B) and v (6, n, B)."""
    if on_cpu(q):
        return bias_and_v_plain(model, q, qd, gravity)
    B = check(model, [q, qd])
    c, v = empty(model, model.n, B), empty(model, 6, model.n, B)
    if B:
        launch("bias_and_v", "grid_bias_v", model,
                (q.data_ptr(), qd.data_ptr(), c.data_ptr(), v.data_ptr()),
                B, float(gravity))
    return c, v


def minv_qdd_dense_staged(model: RobotModel, q, rhs=None):
    """K2′: (M⁻¹,) dense symmetric (n, n, B), or (M⁻¹, q̈ = M⁻¹·rhs) when a
    right-hand side (n, B) is given."""
    if on_cpu(q):
        return minv_qdd_dense_plain(model, q, rhs)
    B = check(model, [q] + ([] if rhs is None else [rhs]))
    n = model.n
    Minv = empty(model, n, n, B)
    qdd = None if rhs is None else empty(model, n, B)
    if B:
        launch("minv_dense", "grid_minv_dense", model,
                (q.data_ptr(), ptr(rhs), Minv.data_ptr(), ptr(qdd)), B)
    return (Minv,) if rhs is None else (Minv, qdd)


def af_staged(model: RobotModel, q, qd, qdd, v, gravity=-9.81):
    """K4: a, f (6, n, B) at the true q̈, v (6, n, B) reused."""
    if on_cpu(q):
        return af_plain(model, q, qd, qdd, v, gravity)
    B = check(model, [q, qd, qdd])
    check_staged(model, "v", v, (6, model.n, B))
    a, f = empty(model, 6, model.n, B), empty(model, 6, model.n, B)
    if B:
        launch("af", "grid_af", model,
                (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), v.data_ptr(),
                 a.data_ptr(), f.data_ptr()), B, float(gravity))
    return a, f


def vaf_staged(model: RobotModel, q, qd, qdd, gravity=-9.81):
    """∂ID's sweep: v, a, f (6, n, B), f summed to the root."""
    if on_cpu(q):
        return vaf_plain(model, q, qd, qdd, gravity)
    B = check(model, [q, qd, qdd])
    v, a, f = (empty(model, 6, model.n, B) for _ in range(3))
    if B:
        launch("vaf", "grid_vaf", model,
                (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), v.data_ptr(),
                 a.data_ptr(), f.data_ptr()), B, float(gravity))
    return v, a, f


def grad_cols_staged(model: RobotModel, q, qd, v, a, f, gravity=-9.81,
                     cb=None, Minv=None):
    """K5: every column block of both sides in one launch — (∂c/∂q,
    ∂c/∂q̇), or with ``Minv`` (n, n, B) the fused −M⁻¹·∂c finish."""
    if on_cpu(q):
        return grad_cols_plain(model, q, qd, v, a, f, gravity, cb, Minv)
    B = check(model, [q, qd])
    n = model.n
    for name, t in (("v", v), ("a", a), ("f", f)):
        check_staged(model, name, t, (6, n, B))
    if Minv is not None:
        check_staged(model, "Minv", Minv, (n, n, B))
    cb = _col_block(model, cb)
    dq, dqd = empty(model, n, n, B), empty(model, n, n, B)
    if B:
        launch("grad_cols" if Minv is None else "grad_cols_finish",
                "grid_grad_cols", model,
                (q.data_ptr(), qd.data_ptr(), v.data_ptr(), a.data_ptr(),
                 f.data_ptr(), ptr(Minv), dq.data_ptr(), dqd.data_ptr()),
                B, cb, float(gravity))
    return dq, dqd


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------
def id_grad_staged(model: RobotModel, q, qd, qdd, gravity=-9.81, cb=None):
    """Staged ∂ID: (∂c/∂q, ∂c/∂q̇), each (n, n, B)."""
    v, a, f = vaf_staged(model, q, qd, qdd, gravity)
    return grad_cols_staged(model, q, qd, v, a, f, gravity, cb=cb)


def fd_grad_staged(model: RobotModel, q, qd, u, gravity=-9.81, cb=None):
    """Staged ∇FD: (∂q̈/∂q, ∂q̈/∂q̇), each (n, n, B) — K1, K2′ (dense M⁻¹
    and q̈), K4, K5 with the fused finish."""
    c, v = bias_and_v_staged(model, q, qd, gravity)
    Minv, qdd = minv_qdd_dense_staged(model, q, u - c)
    a, f = af_staged(model, q, qd, qdd, v, gravity)
    return grad_cols_staged(model, q, qd, v, a, f, gravity, cb=cb, Minv=Minv)
