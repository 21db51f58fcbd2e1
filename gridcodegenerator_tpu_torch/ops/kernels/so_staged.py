"""The staged λᵀ·∂²q̈/∂x∂x pipeline for large robots, and its plain stages.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/so_staged.py``
(``fd_hessian_vp_staged``, so_staged.py:212). The single-thread Hessian
kernel runs the whole ∇FD body in dual numbers, ≈ 56·n² values a state;
past ``MAX_HESSIAN_JOINTS`` joints the sweep is cut into stages whose
per-thread arrays grow as n (or n·cb), with the tangent direction on the
launch grid and per-direction tangents staged through device memory:

  primal  K1, K2′, K4, K5 without the finish (:mod:`.staged`): c, v, M⁻¹,
          q̈, a, f and ∂c on both sides, once for all directions
  T1      jvp of K1                      → dc (n), dv (6, n)  a direction
  T2 (q)  CRBA jvp, then −M⁻¹ products   → dlamM (n), dq̈ (n)
          (q̇-directions: dq̈ = −M⁻¹·dc, dlamM = 0)
  T4      jvp of K4 (tangents of q or q̇, q̈, v)  → da, df (6, n)
  T5      jvp of K5's rows over one column block, contracted with
          lamM = M⁻¹λ                    → −lamMᵀ·d∂c (w)

Two exact savings, as in the JAX code (so_staged.py:18-31): q̈ is affine
in u, so there are no u-direction sweeps (the (u, q) block is dlamM, the
(q̇, u) and (u, u) blocks are exact zeros); and H is symmetric, so the
q-direction sweeps give whole rows and the q̇-direction sweeps only the
(q̇, q̇) block. The product-rule term −dlamMᵀ·∂c, the q̇-direction
dq̈ = −M⁻¹·dc and lamM = M⁻¹λ are batched matrix products outside any
kernel, as the JAX package leaves them to XLA (so_staged.py:261, :363,
:376); they run in full float32 (``allow_tf32`` must stay off).

Each stage wrapper runs its plain version (``t*_plain``: one
JVP, ``ops.so.jvp``, of the plain stage over the repeated states, the
directions as one batch) on CPU tensors and its kernel (``csrc/so.cu``)
on CUDA tensors, or raises.
"""

from __future__ import annotations

import torch

from ...models.robot import RobotModel
from .. import blops
from ..so import jvp, merge_dirs, one_hot_dirs, repeat_dirs, split_dirs
from . import _build, staged
from ._launch import check, check_staged, empty, launch, on_cpu

_SIDES = ("q", "qd")


def _so_col_block(model: RobotModel, cb):
    full = _build.so_col_block(model.n)
    if cb is None:
        return full
    if not 1 <= cb <= full:
        raise ValueError(f"cb must be in [1, {full}] for robot "
                         f"'{model.name}' (n={model.n}), got {cb}")
    return cb


def _which_args(which, q, qd):
    """The perturbed argument (0: q, 1: q̇) and a function rebuilding
    (q, q̇) around its replacement."""
    if which == 0:
        return q, lambda z: (z, qd)
    return qd, lambda z: (q, z)


def crba_matvecs(model: RobotModel, X, vecs):
    """(M·x for x in vecs) with M from the batch-last CRBA, over its
    structurally nonzero (root-path) entries only (so_staged.py:192)."""
    M = blops.crba_bl(model, X)
    n = model.n
    outs = []
    for x in vecs:
        rows = []
        for i in range(n):
            acc = None
            for j in range(n):
                if M[i][j] is None:
                    continue
                t = M[i][j] * x[j:j + 1]
                acc = t if acc is None else acc + t
            rows.append(acc)
        outs.append(torch.cat(rows))
    return outs


# --------------------------------------------------------------------------
# plain stages (any device); outputs are direction-major (n_dirs, …, B)
# --------------------------------------------------------------------------
def t1_plain(model: RobotModel, q, qd, which, gravity=-9.81):
    """T1, the jvp of K1 along the n directions of q (which = 0) or q̇ (1):
    dc (n, n, B), dv (n, 6, n, B)."""
    n, B = model.n, q.shape[-1]
    arg, rebuild = _which_args(which, repeat_dirs(q, n), repeat_dirs(qd, n))
    _, (dc, dv) = jvp(
        lambda z: staged.bias_and_v_plain(model, *rebuild(z), gravity),
        (arg,), (one_hot_dirs(n, B, q),))
    return split_dirs(dc, n), split_dirs(dv, n)


def t2_plain(model: RobotModel, q, lamM, qdd, Minv, dc):
    """T2 for the q-directions: dlamM = −M⁻¹·(dM·lamM) and
    dq̈ = −M⁻¹·(dM·q̈ + dc), each (n, n, B); dc from T1."""
    n, B = model.n, q.shape[-1]
    lam_r, qdd_r, Minv_r = (repeat_dirs(x, n) for x in (lamM, qdd, Minv))

    def mv(z):
        X = blops.joint_transforms_bl(model, z)
        return tuple(crba_matvecs(model, X, (lam_r, qdd_r)))

    _, (dMlam, dMq) = jvp(mv, (repeat_dirs(q, n),),
                                     (one_hot_dirs(n, B, q),))
    dlamM = -blops.matvecN(Minv_r, dMlam)
    dqdd = -blops.matvecN(Minv_r, dMq + merge_dirs(dc))
    return split_dirs(dlamM, n), split_dirs(dqdd, n)


def t4_plain(model: RobotModel, q, qd, qdd, v, dv, dqdd, which,
             gravity=-9.81):
    """T4, the jvp of K4 along the directions of q or q̇, with the tangents
    dq̈ (n, n, B) and dv (n, 6, n, B) of its other inputs: da, df
    (n, 6, n, B)."""
    n, B = model.n, q.shape[-1]
    arg, rebuild = _which_args(which, repeat_dirs(q, n), repeat_dirs(qd, n))

    def af(z, qdd_, v_):
        return staged.af_plain(model, *rebuild(z), qdd_, v_, gravity)

    _, (da, df) = jvp(
        af, (arg, repeat_dirs(qdd, n), repeat_dirs(v, n)),
        (one_hot_dirs(n, B, q), merge_dirs(dqdd), merge_dirs(dv)))
    return split_dirs(da, n), split_dirs(df, n)


def t5_plain(model: RobotModel, q, qd, v, a, f, lamM, dv, da, df, which,
             side, gravity=-9.81, cb=None):
    """T5 over every column block of one side: −lamMᵀ·d(∂c/∂side) along the
    directions of q or q̇, (n_dirs, n, B)."""
    n, B = model.n, q.shape[-1]
    cb = _so_col_block(model, cb)
    arg, rebuild = _which_args(which, repeat_dirs(q, n), repeat_dirs(qd, n))
    lam_r = repeat_dirs(lamM, n)
    primals = (arg, *(repeat_dirs(t, n) for t in (v, a, f)))
    tangents = (one_hot_dirs(n, B, q), *(merge_dirs(t) for t in (dv, da, df)))
    blocks = []
    for c0, w in staged._blocks(n, cb):
        def rowblk(z, v_, a_, f_, _c0=c0, _w=w):
            q_, qd_ = rebuild(z)
            X = blops.joint_transforms_bl(model, q_)
            vl, al, fl = (staged._as_list(t, n) for t in (v_, a_, f_))
            rows = blops.rnea_grad_cols_bl(model, X, qd_, vl, al, fl, gravity,
                                           c0=_c0, cb=_w, sides=(side,),
                                           as_rows=True)[side]
            acc = None
            for i, r in enumerate(rows):
                if r is None:
                    continue
                t = lam_r[i:i + 1] * r
                acc = t if acc is None else acc + t
            return acc

        _, drow = jvp(rowblk, primals, tangents)
        blocks.append(-drow)
    return split_dirs(torch.cat(blocks), n)


# --------------------------------------------------------------------------
# stage wrappers: the plain stage on CPU tensors, the kernel on CUDA tensors
# --------------------------------------------------------------------------
def _check_which(which):
    if which not in (0, 1):
        raise ValueError(f"which must be 0 (q) or 1 (q̇), got {which}")


def t1_staged(model: RobotModel, q, qd, which, gravity=-9.81):
    """T1: dc (n, n, B), dv (n, 6, n, B)."""
    _check_which(which)
    if on_cpu(q):
        return t1_plain(model, q, qd, which, gravity)
    B = check(model, [q, qd])
    n = model.n
    dc, dv = empty(model, n, n, B), empty(model, n, 6, n, B)
    if B:
        launch("t1", "grid_t1", model,
               (q.data_ptr(), qd.data_ptr(), dc.data_ptr(), dv.data_ptr()),
               B, which, float(gravity))
    return dc, dv


def t2_staged(model: RobotModel, q, lamM, qdd, Minv, dc):
    """T2 (q-directions): dlamM, dq̈ (n, n, B)."""
    if on_cpu(q):
        return t2_plain(model, q, lamM, qdd, Minv, dc)
    B = check(model, [q, lamM, qdd])
    n = model.n
    check_staged(model, "Minv", Minv, (n, n, B))
    check_staged(model, "dc", dc, (n, n, B))
    dlamM, dqdd = empty(model, n, n, B), empty(model, n, n, B)
    if B:
        launch("t2", "grid_t2", model,
               (q.data_ptr(), lamM.data_ptr(), qdd.data_ptr(),
                Minv.data_ptr(), dc.data_ptr(), dlamM.data_ptr(),
                dqdd.data_ptr()), B)
    return dlamM, dqdd


def t4_staged(model: RobotModel, q, qd, qdd, v, dv, dqdd, which,
              gravity=-9.81):
    """T4: da, df (n, 6, n, B)."""
    _check_which(which)
    if on_cpu(q):
        return t4_plain(model, q, qd, qdd, v, dv, dqdd, which, gravity)
    B = check(model, [q, qd, qdd])
    n = model.n
    check_staged(model, "v", v, (6, n, B))
    check_staged(model, "dv", dv, (n, 6, n, B))
    check_staged(model, "dqdd", dqdd, (n, n, B))
    da, df = empty(model, n, 6, n, B), empty(model, n, 6, n, B)
    if B:
        launch("t4", "grid_t4", model,
               (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), v.data_ptr(),
                dv.data_ptr(), dqdd.data_ptr(), da.data_ptr(),
                df.data_ptr()), B, which, float(gravity))
    return da, df


def t5_staged(model: RobotModel, q, qd, v, a, f, lamM, dv, da, df, which,
              side, gravity=-9.81, cb=None):
    """T5: every column block of one side in one launch (a 3-D grid:
    states, directions, blocks) → (n, n, B)."""
    _check_which(which)
    if side not in _SIDES:
        raise ValueError(f"side must be one of {_SIDES}, got {side!r}")
    if on_cpu(q):
        return t5_plain(model, q, qd, v, a, f, lamM, dv, da, df, which, side,
                        gravity, cb)
    B = check(model, [q, qd, lamM])
    n = model.n
    for name, t in (("v", v), ("a", a), ("f", f)):
        check_staged(model, name, t, (6, n, B))
    for name, t in (("dv", dv), ("da", da), ("df", df)):
        check_staged(model, name, t, (n, 6, n, B))
    cb = _so_col_block(model, cb)
    out = empty(model, n, n, B)
    if B:
        launch("t5", "grid_t5", model,
               (q.data_ptr(), qd.data_ptr(), v.data_ptr(), a.data_ptr(),
                f.data_ptr(), lamM.data_ptr(), dv.data_ptr(), da.data_ptr(),
                df.data_ptr(), out.data_ptr()),
               B, which, int(side == "q"), cb, float(gravity))
    return out


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------
class _Stages:
    """The stage functions one run of the pipeline calls."""

    def __init__(self, plain):
        self.bias_and_v = (staged.bias_and_v_plain if plain
                           else staged.bias_and_v_staged)
        self.minv_qdd = (staged.minv_qdd_dense_plain if plain
                         else staged.minv_qdd_dense_staged)
        self.af = staged.af_plain if plain else staged.af_staged
        self.grad_cols = (staged.grad_cols_plain if plain
                          else staged.grad_cols_staged)
        self.t1 = t1_plain if plain else t1_staged
        self.t2 = t2_plain if plain else t2_staged
        self.t4 = t4_plain if plain else t4_staged
        self.t5 = t5_plain if plain else t5_staged


_KERNEL_STAGES = _Stages(plain=False)
_PLAIN_STAGES = _Stages(plain=True)


def _vp_pipeline(S, model, q, qd, u, lam, gravity, cb):
    n = model.n
    cb = _so_col_block(model, cb)
    c, v = S.bias_and_v(model, q, qd, gravity)
    Minv, qdd = S.minv_qdd(model, q, u - c)
    a, f = S.af(model, q, qd, qdd, v, gravity)
    dcq_p, dcqd_p = S.grad_cols(model, q, qd, v, a, f, gravity)
    lamM = torch.einsum("ijb,jb->ib", Minv, lam).contiguous()

    def t5(which, side, dv, da, df):
        return S.t5(model, q, qd, v, a, f, lamM, dv, da, df, which, side,
                    gravity, cb)

    # q-directions: whole 3n rows
    dc_q, dv_q = S.t1(model, q, qd, 0, gravity)
    dlamM, dqdd_q = S.t2(model, q, lamM, qdd, Minv, dc_q)
    da_q, df_q = S.t4(model, q, qd, qdd, v, dv_q, dqdd_q, 0, gravity)
    Aq = t5(0, "q", dv_q, da_q, df_q)
    Aqd = t5(0, "qd", dv_q, da_q, df_q)
    del dv_q, da_q, df_q, dc_q, dqdd_q
    # product rule: λᵀ·d(−M⁻¹∂c) also carries −dlamMᵀ·∂c
    Aq -= torch.einsum("dib,ijb->djb", dlamM, dcq_p)
    Aqd -= torch.einsum("dib,ijb->djb", dlamM, dcqd_p)
    Hq = torch.cat([Aq, Aqd, dlamM], dim=1).transpose(0, 1)   # (3n, n, B)
    del Aq, Aqd

    # q̇-directions: the (q̇, q̇) block only; dM/dq̇ = 0
    dc_d, dv_d = S.t1(model, q, qd, 1, gravity)
    dqdd_d = -torch.einsum("ijb,djb->dib", Minv, dc_d).contiguous()
    da_d, df_d = S.t4(model, q, qd, qdd, v, dv_d, dqdd_d, 1, gravity)
    Hqdqd = t5(1, "qd", dv_d, da_d, df_d).transpose(0, 1)
    del dv_d, da_d, df_d

    # assembly: H[a, b] = H[b, a]; (q̇, u) = (u, u) = 0
    H = torch.zeros((3 * n, 3 * n) + tuple(q.shape[1:]), dtype=q.dtype,
                    device=q.device)
    H[:, :n] = Hq
    H[:n, n:] = Hq[n:].transpose(0, 1)
    H[n:2 * n, n:2 * n] = Hqdqd
    return H


def fd_hessian_vp_staged(model: RobotModel, q, qd, u, lam, gravity=-9.81,
                         cb=None):
    """Staged λᵀ·∂²q̈/∂x∂x: q, q̇, u, λ (n, B) → (3n, 3n, B). Ten kernel
    launches: K1, K2′, K4, K5 (primal); T1, T2, T4, T5 × 2 (q-directions);
    T1, T4, T5 (q̇-directions). The (q̇, u) and (u, u) blocks are exact
    zeros."""
    return _vp_pipeline(_KERNEL_STAGES, model, q, qd, u, lam, gravity, cb)


def fd_hessian_vp_staged_plain(model: RobotModel, q, qd, u, lam,
                               gravity=-9.81, cb=None):
    """The same pipeline on the plain stages, on any device: what the
    staged λᵀ·H is held to on the card."""
    return _vp_pipeline(_PLAIN_STAGES, model, q, qd, u, lam, gravity, cb)


def fd_hessian_staged(model: RobotModel, q, qd, u, gravity=-9.81, cb=None):
    """The full ∂²q̈/∂x∂x, (n, 3n, 3n, B), as n staged λᵀ·H calls with
    λ = e_i (H[i] = e_iᵀ·H): n times the cost of one
    :func:`fd_hessian_vp_staged`."""
    n = model.n
    H = []
    for i in range(n):
        lam = torch.zeros_like(q)
        lam[i] = 1.0
        H.append(fd_hessian_vp_staged(model, q, qd, u, lam, gravity, cb))
    return torch.stack(H)
