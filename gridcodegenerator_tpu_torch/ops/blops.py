"""Batch-last plain PyTorch versions of the first-order algorithms.

The port's counterpart of ``gridcodegenerator_tpu/ops/blops.py:1-510``:
every spatial quantity carries a trailing batch axis (``v: (6, B)``,
``X_i: (6, 6, B)``, ``∂v_i: (6, k, B)``) and every contraction is the same
unrolled sum over the small (≤ 6 or n) index, in the same order, as the JAX
code — so the two agree at float64 round-off. These functions are the plain
versions the CUDA kernels (``kernels/csrc``) are held to, and the CPU branch
of every wrapper in :mod:`.kernels.fused`. The column-blocked M⁻¹
(:func:`minv_UD_bl`, :func:`minv_cols_bl`: blops.py:515, :588) and
``fd_grad_bl``'s ``minv_fn`` (:475) follow the JAX code the same way.

Robot constants are broadcast with trailing unit axes instead of being
expanded to the batch (the JAX code's ``batchify``, a Mosaic workaround);
the arithmetic is the same.
"""

from __future__ import annotations

import torch

from ..models.robot import RobotModel

# --------------------------------------------------------------------------
# batch-last primitives
# --------------------------------------------------------------------------


def matvec6(X, v):
    """(6,6,B) · (6,B) → (6,B): out[r,b] = Σ_c X[r,c,b]·v[c,b]."""
    return sum(X[:, c] * v[c:c + 1] for c in range(6))


def matvec6_T(X, v):
    """Xᵀ·v: out[r,b] = Σ_c X[c,r,b]·v[c,b]."""
    return sum(X[c] * v[c:c + 1] for c in range(6))


def matmat6(X, D):
    """(6,6,B) · (6,k,B) → (6,k,B)."""
    return sum(X[:, c][:, None] * D[c][None] for c in range(6))


def matmat6_T(X, D):
    """Xᵀ·D: (6,6,B)ᵀ · (6,k,B) → (6,k,B)."""
    return sum(X[c][:, None] * D[c][None] for c in range(6))


def cross3_bl(a, b):
    """(3,B) × (3,B) → (3,B)."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def crm_apply_bl(m, x):
    """m × x on (6,B): [ω_m×x_ω ; ω_m×x_v + v_m×x_ω]."""
    return torch.cat([
        cross3_bl(m[:3], x[:3]),
        cross3_bl(m[:3], x[3:]) + cross3_bl(m[3:], x[:3]),
    ])


def crf_apply_bl(m, x):
    """m ×* x on (6,B): [ω_m×x_ω + v_m×x_v ; ω_m×x_v]."""
    return torch.cat([
        cross3_bl(m[:3], x[:3]) + cross3_bl(m[3:], x[3:]),
        cross3_bl(m[:3], x[3:]),
    ])


def _cross3_cols(A, Bc):
    return torch.stack([
        A[1] * Bc[2] - A[2] * Bc[1],
        A[2] * Bc[0] - A[0] * Bc[2],
        A[0] * Bc[1] - A[1] * Bc[0],
    ])


def crm_cols_left(m, D):
    """crm(m)·D per column: m (6,B), D (6,k,B) → (6,k,B)."""
    w = m[:3][:, None]
    u_ = m[3:][:, None]
    return torch.cat([
        _cross3_cols(w, D[:3]),
        _cross3_cols(w, D[3:]) + _cross3_cols(u_, D[:3]),
    ])


def crf_cols_right(D, x):
    """crf(D_col)·x per column: D (6,k,B), x (6,B) → (6,k,B)."""
    xw = x[:3][:, None]
    xv = x[3:][:, None]
    return torch.cat([
        _cross3_cols(D[:3], xw) + _cross3_cols(D[3:], xv),
        _cross3_cols(D[:3], xv),
    ])


def crf_cols_left(m, D):
    """crf(m)·D_col per column: m (6,B), D (6,k,B) → (6,k,B)."""
    w = m[:3][:, None]
    u_ = m[3:][:, None]
    return torch.cat([
        _cross3_cols(w, D[:3]) + _cross3_cols(u_, D[3:]),
        _cross3_cols(w, D[3:]),
    ])


def _col(vec):
    """(k,) constant → (k, 1), broadcastable against (k, B)."""
    return vec[:, None]


def _mat(M):
    """(6, 6) constant → (6, 6, 1), broadcastable against (6, 6, B)."""
    return M[:, :, None]


def _iota_eq(k, i, like):
    """(k, 1) indicator of index i, in ``like``'s dtype and device."""
    return (torch.arange(k, device=like.device) == i).to(like.dtype)[:, None]


# --------------------------------------------------------------------------
# joint transforms
# --------------------------------------------------------------------------
def joint_transforms_bl(model: RobotModel, q, joints=None):
    """q (n, B) → list of n (6, 6, B) transforms, affine in sin/cos (revolute)
    or in q (prismatic); with ``joints``, only those (None elsewhere)."""
    out = []
    for i in range(model.n):
        if joints is not None and i not in joints:
            out.append(None)
            continue
        qi = q[i:i + 1]
        if model.joint_types[i] == "prismatic":
            out.append(_mat(model.Xb[i]) + _mat(model.Xs[i]) * qi)
        else:
            out.append(_mat(model.Xb[i]) + _mat(model.Xs[i]) * torch.sin(qi)
                       + _mat(model.Xc[i]) * torch.cos(qi))
    return out


# --------------------------------------------------------------------------
# RNEA
# --------------------------------------------------------------------------
def rnea_fwd_bl(model: RobotModel, X, qd, qdd=None, gravity=-9.81,
                v_known=None):
    """Forward sweep: qd/qdd (n, B) → v, a, f lists of (6, B)."""
    n = model.n
    parents = model.topology.parents
    v = list(v_known) if v_known is not None else [None] * n
    a = [None] * n
    f = [None] * n
    for i in range(n):
        p = parents[i]
        Sb = _col(model.S[i])
        Sqd = Sb * qd[i:i + 1]
        if v_known is None:
            v[i] = Sqd if p < 0 else matvec6(X[i], v[p]) + Sqd
        if p < 0:
            # X·a_base with a_base = [0,…,0,−gravity]: column 5 of X scaled
            ai = X[i][:, 5] * (-gravity)
        else:
            ai = matvec6(X[i], a[p])
        ai = ai + crm_apply_bl(v[i], Sqd)
        if qdd is not None:
            ai = ai + Sb * qdd[i:i + 1]
        a[i] = ai
    for i in range(n):
        Ib = _mat(model.inertia[i])
        Iv = matvec6(Ib, v[i])
        f[i] = matvec6(Ib, a[i]) + crf_apply_bl(v[i], Iv)
    return v, a, f


def rnea_bwd_bl(model: RobotModel, X, f, qd=None, qdd=None):
    """Backward sweep: wrenches to the root, then c_i = S_iᵀ f_i (+ damping
    and armature terms). Returns (c (n, B), f)."""
    n = model.n
    parents = model.topology.parents
    f = list(f)
    for i in range(n - 1, -1, -1):
        p = parents[i]
        if p >= 0:
            f[p] = f[p] + matvec6_T(X[i], f[i])
    F_all = torch.stack(f)                                  # (n, 6, B)
    c = sum(model.S[:, r:r + 1] * F_all[:, r] for r in range(6))
    if qd is not None:
        c = c + _col(model.damping) * qd
    if qdd is not None:
        c = c + _col(model.armature) * qdd
    return c, f


def rnea_bl(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    """Batch-last inverse dynamics: q/qd/qdd (n, B) → c (n, B), v, a, f."""
    X = joint_transforms_bl(model, q)
    v, a, f = rnea_fwd_bl(model, X, qd, qdd, gravity)
    c, f = rnea_bwd_bl(model, X, f, qd, qdd)
    return c, v, a, f


# --------------------------------------------------------------------------
# direct M⁻¹
# --------------------------------------------------------------------------
def minv_bl(model: RobotModel, X):
    """Batch-last analytic M⁻¹ (the articulated recursion): returns the rows
    list [n] of (n, B) with upper-triangular semantics, U and D⁻¹."""
    n = model.n
    parents = model.topology.parents
    like = X[0]
    B = like.shape[-1]
    IA = [_mat(model.inertia[i]) for i in range(n)]
    Sb = [_col(model.S[i]) for i in range(n)]
    rows = [None] * n
    F = [torch.zeros((6, n, B), dtype=like.dtype, device=like.device)
         for _ in range(n)]
    U = [None] * n
    Dinv = [None] * n

    for i in range(n - 1, -1, -1):
        S = Sb[i]
        Ui = sum(IA[i][:, c] * S[c:c + 1] for c in range(6))     # (6,B)
        d = sum(S[c:c + 1] * Ui[c:c + 1] for c in range(6))      # (1,B)
        Di = 1.0 / (d + model.armature[i:i + 1, None])
        U[i], Dinv[i] = Ui, Di
        SF = sum(S[c:c + 1] * F[i][c] for c in range(6))         # (n,B)
        # row = e_i·D⁻¹ − D⁻¹·SᵀF
        row = _iota_eq(n, i, like) * Di - Di * SF
        rows[i] = row
        p = parents[i]
        if p >= 0:
            Fi = F[i] + Ui[:, None] * row[None]
            F[i] = Fi
            F[p] = F[p] + matmat6_T(X[i], Fi)
            UDU = Ui[:, None] * (Di[:, None] * Ui[None])
            Ia = IA[i] - UDU
            IA[p] = IA[p] + matmat6_T(X[i], matmat6(Ia, X[i]))
    # serial forward sweep over the columns j ≥ i (the rest stay as they are)
    for i in range(n):
        p = parents[i]
        if p >= 0:
            UX = matvec6_T(X[i], U[i])                           # Uᵀ·X (6,B)
            corr = sum(UX[c:c + 1] * F[p][c, i:] for c in range(6))
            rows[i] = torch.cat([rows[i][:i], rows[i][i:] - Dinv[i] * corr])
        new_cols = torch.stack([Sb[i][r:r + 1] * rows[i][i:]
                                for r in range(6)])              # (6,n-i,B)
        if p >= 0:
            new_cols = new_cols + matmat6(X[i], F[p][:, i:])
        F[i] = torch.cat([F[i][:, :i], new_cols], dim=1)
    return rows, U, Dinv


def densify_rows(rows):
    """rows list [n] of (n,B) upper-triangular → dense symmetric (n,n,B)."""
    n = len(rows)
    M = torch.stack(rows)
    r = torch.arange(n, device=M.device)[:, None, None]
    c = torch.arange(n, device=M.device)[None, :, None]
    upper_mask = (c >= r).to(M.dtype)
    strict_mask = (c > r).to(M.dtype)
    return M * upper_mask + (M * strict_mask).transpose(0, 1)


def matvecN(M, x):
    """(n,n,B) · (n,B) → (n,B)."""
    n = M.shape[0]
    return sum(M[:, c] * x[c:c + 1] for c in range(n))


def matmatN(M, D, negate=False):
    """(n,n,B) · (n,k,B) → (n,k,B)."""
    n = M.shape[0]
    out = sum(M[:, c][:, None] * D[c][None] for c in range(n))
    return -out if negate else out


def fd_bl(model: RobotModel, q, qd, u, gravity=-9.81):
    """Batch-last forward dynamics by the M⁻¹ composition."""
    X = joint_transforms_bl(model, q)
    v, a, f = rnea_fwd_bl(model, X, qd, None, gravity)
    c, _ = rnea_bwd_bl(model, X, f, qd)
    rows, _, _ = minv_bl(model, X)
    return matvecN(densify_rows(rows), u - c)


# --------------------------------------------------------------------------
# ∂ID inner and ∇FD
# --------------------------------------------------------------------------
def rnea_grad_inner_bl(model: RobotModel, X, qd, v, a, f, gravity=-9.81,
                       sides=("q", "qd")):
    """Batch-last analytic ∂ID: ``{"q": dc_dq, "qd": dc_dqd}`` for the
    requested sides, each (n, n, B). One side at a time keeps only that
    side's ∂-tensors live."""
    n = model.n
    parents = model.topology.parents
    B = qd.shape[-1]
    dtype, device = qd.dtype, qd.device

    Ib = [_mat(model.inertia[i]) for i in range(n)]
    S_bl = [_col(model.S[i]) for i in range(n)]

    def zeros_cols(k):
        return torch.zeros((6, k, B), dtype=dtype, device=device)

    Iv = [matvec6(Ib[i], v[i]) for i in range(n)]
    Xv = [matvec6(X[i], v[parents[i]]) if parents[i] >= 0
          else torch.zeros((6, B), dtype=dtype, device=device)
          for i in range(n)]
    Xa = [matvec6(X[i], a[parents[i]]) if parents[i] >= 0
          else X[i][:, 5] * (-gravity) for i in range(n)]

    SxXv = [crm_apply_bl(S_bl[i], Xv[i]) for i in range(n)]
    SxXa = [crm_apply_bl(S_bl[i], Xa[i]) for i in range(n)]
    Sxv = [crm_apply_bl(S_bl[i], v[i]) for i in range(n)]
    # force-cross form of the backward correction (exact for prismatic too)
    Sxf = [crf_apply_bl(S_bl[i], f[i]) for i in range(n)]

    def one_side(side):
        is_q = side == "q"
        # ancestor sparsity: ∂v_i, ∂a_i are nonzero only in columns [0, i]
        dv = [None] * n   # dv[i]: (6, i+1, B)
        for i in range(n):
            p = parents[i]
            seed = (-SxXv[i] if p >= 0 else zeros_cols(1)[:, 0]) if is_q \
                else S_bl[i].expand(6, B)
            head = [matmat6(X[i], dv[p])] if p >= 0 else []
            gap = i - (p + 1 if p >= 0 else 0)
            if gap:
                head.append(zeros_cols(gap))
            head.append(seed[:, None])
            dv[i] = torch.cat(head, dim=1)

        da = [None] * n   # da[i]: (6, i+1, B)
        for i in range(n):
            qdi = qd[i:i + 1][:, None]
            seed = -SxXa[i] if is_q else -Sxv[i]
            local = -qdi * crm_cols_left(S_bl[i], dv[i])
            mask = _iota_eq(i + 1, i, qd)[None]                  # (1,i+1,1)
            da[i] = local + mask * seed[:, None]
        for i in range(n):
            p = parents[i]
            if p >= 0:
                prop = matmat6(X[i], da[p])                      # width p+1
                da[i] = torch.cat([da[i][:, :p + 1] + prop,
                                   da[i][:, p + 1:]], dim=1)

        df = [None] * n   # df[i]: (6, n, B), full width for the backward sweep
        for i in range(n):
            # df = crf(dv)·Iv + I·da + crf(v)·(I·dv)
            Idv = matmat6(Ib[i], dv[i])
            local = (crf_cols_right(dv[i], Iv[i])
                     + matmat6(Ib[i], da[i])
                     + crf_cols_left(v[i], Idv))                 # width i+1
            df[i] = (local if i == n - 1
                     else torch.cat([local, zeros_cols(n - 1 - i)], dim=1))

        for i in range(n - 1, -1, -1):
            p = parents[i]
            if p >= 0:
                df[p] = df[p] + matmat6_T(X[i], df[i])
                if is_q:
                    # add Xᵀ·(S ×* f) into column i
                    df[p] = (df[p] + _iota_eq(n, i, qd)[None]
                             * matvec6_T(X[i], Sxf[i])[:, None])

        dc = torch.stack([
            sum(S_bl[i][r:r + 1] * df[i][r] for r in range(6))
            for i in range(n)])
        if not is_q:
            # damping on the ∂c/∂q̇ diagonal
            eye = torch.eye(n, dtype=dtype, device=device)[:, :, None]
            dc = dc + eye * model.damping[:, None, None]
        return dc

    return {side: one_side(side) for side in sides}


def fd_grad_bl(model: RobotModel, q, qd, u, gravity=-9.81, minv_fn=None):
    """Batch-last ∇FD: q/qd/u (n, B) → (∂q̈/∂q, ∂q̈/∂q̇), each (n, n, B).

    One X evaluation, v reused across the two RNEA sweeps; the q and q̇
    sides run one after the other and each is contracted with −M⁻¹ at once.
    ``minv_fn(model, X) -> (n, n, B)`` replaces the articulated M⁻¹
    recursion (``kernels.fused._dense_minv_bl``: CRBA + Cholesky).
    """
    X = joint_transforms_bl(model, q)
    v, a0, f0 = rnea_fwd_bl(model, X, qd, None, gravity)
    c, _ = rnea_bwd_bl(model, X, f0, qd)
    if minv_fn is None:
        rows, _, _ = minv_bl(model, X)
        Minv = densify_rows(rows)                   # (n,n,B)
    else:
        Minv = minv_fn(model, X)
    qdd = matvecN(Minv, u - c)
    _, a, f = rnea_fwd_bl(model, X, qd, qdd, gravity, v_known=v)
    _, f = rnea_bwd_bl(model, X, f, None)
    dq = rnea_grad_inner_bl(model, X, qd, v, a, f, gravity, sides=("q",))["q"]
    ddq = matmatN(Minv, dq, negate=True)
    dqd = rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                             sides=("qd",))["qd"]
    ddqd = matmatN(Minv, dqd, negate=True)
    return ddq, ddqd


# --------------------------------------------------------------------------
# column-blocked variants (the staged large-robot pipeline, kernels/staged.py)
# --------------------------------------------------------------------------
def minv_UD_bl(model: RobotModel, X):
    """The backward articulated-inertia sweep of :func:`minv_bl` alone: U
    (list of (6, B)) and D⁻¹ (list of (1, B)) — the column-independent half
    of the M⁻¹ recursion, staged apart so that the F and row sweeps
    (:func:`minv_cols_bl`) can run a column block at a time. A leaf's U and
    D⁻¹ do not depend on q and keep a unit batch axis."""
    n = model.n
    parents = model.topology.parents
    IA = [_mat(model.inertia[i]) for i in range(n)]
    Sb = [_col(model.S[i]) for i in range(n)]
    U = [None] * n
    Dinv = [None] * n
    for i in range(n - 1, -1, -1):
        S = Sb[i]
        Ui = sum(IA[i][:, c] * S[c:c + 1] for c in range(6))
        Di = 1.0 / (sum(S[c:c + 1] * Ui[c:c + 1] for c in range(6))
                    + model.armature[i:i + 1, None])
        U[i], Dinv[i] = Ui, Di
        p = parents[i]
        if p >= 0:
            UDU = Ui[:, None] * (Di[:, None] * Ui[None])
            Ia = IA[i] - UDU
            IA[p] = IA[p] + matmat6_T(X[i], matmat6(Ia, X[i]))
    return U, Dinv


def minv_cols_bl(model: RobotModel, X, U, Dinv, c0: int, cb: int):
    """Columns [c0, c0 + cb) of the upper-triangular M⁻¹, rows stacked to
    (n, cb, B), from :func:`minv_UD_bl`'s U and D⁻¹: the F and row
    recursions of :func:`minv_bl` restricted to one column block, the
    global column of each local one compared with the joint index as a
    0/1 mask (``gcol``). Entries below the diagonal are left as the first
    sweep made them; :func:`densify_rows` drops them."""
    n = model.n
    parents = model.topology.parents
    B = X[0].shape[-1]
    dtype, device = X[0].dtype, X[0].device
    Sb = [_col(model.S[i]) for i in range(n)]
    rows = [torch.zeros((cb, B), dtype=dtype, device=device)
            for _ in range(n)]
    F = [torch.zeros((6, cb, B), dtype=dtype, device=device)
         for _ in range(n)]
    gcol = torch.arange(c0, c0 + cb, device=device)[:, None]     # (cb, 1)
    for i in range(n - 1, -1, -1):
        S = Sb[i]
        SF = sum(S[c:c + 1] * F[i][c] for c in range(6))          # (cb,B)
        ei = (gcol == i).to(dtype)
        row = ei * Dinv[i] - Dinv[i] * SF
        rows[i] = row
        p = parents[i]
        if p >= 0:
            Fi = F[i] + U[i][:, None] * row[None]
            F[i] = Fi
            F[p] = F[p] + matmat6_T(X[i], Fi)
    for i in range(n):
        p = parents[i]
        geq = (gcol >= i).to(dtype)
        if p >= 0:
            UX = matvec6_T(X[i], U[i])
            corr = sum(UX[c:c + 1] * F[p][c] for c in range(6))
            rows[i] = rows[i] - geq * (Dinv[i] * corr)
        new_cols = torch.stack([Sb[i][r:r + 1] * rows[i] for r in range(6)])
        if p >= 0:
            new_cols = new_cols + matmat6(X[i], F[p])
        F[i] = geq[None] * new_cols + (1 - geq)[None] * F[i]
    return torch.stack(rows)                                       # (n,cb,B)


def crba_bl(model: RobotModel, X):
    """Batch-last Composite Rigid Body Algorithm: the joint-space mass
    matrix ``M + diag(armature)`` as an (n, n) list of lists of (1, B)
    entries, ``None`` where structurally zero (M[i][j] ≠ 0 only for j on
    i's root path; joints of different trees of a forest never couple).
    The list-of-lists form feeds the active-region Cholesky
    (``kernels/contact_fused._chol_factor_act``) directly."""
    n = model.n
    parents = model.topology.parents
    B = X[0].shape[-1]
    IC = [_mat(model.inertia[i]).expand(6, 6, B) for i in range(n)]
    Sb = [_col(model.S[i]) for i in range(n)]
    for i in range(n - 1, -1, -1):
        p = parents[i]
        if p >= 0:
            IC[p] = IC[p] + matmat6_T(X[i], matmat6(IC[i], X[i]))
    M = [[None] * n for _ in range(n)]
    for i in range(n):
        F = sum(IC[i][:, c] * Sb[i][c:c + 1] for c in range(6))   # (6,B)
        M[i][i] = (sum(Sb[i][c:c + 1] * F[c:c + 1] for c in range(6))
                   + model.armature[i:i + 1, None])
        j = i
        while parents[j] >= 0:
            F = matvec6_T(X[j], F)
            j = parents[j]
            val = sum(Sb[j][c:c + 1] * F[c:c + 1] for c in range(6))
            M[i][j] = val
            M[j][i] = val
    return M


def rnea_grad_cols_bl(model: RobotModel, X, qd, v, a, f, gravity=-9.81,
                      c0: int = 0, cb: int | None = None, sides=("q", "qd"),
                      as_rows: bool = False):
    """Column-blocked batch-last ∂ID: the ``cb`` differentiation directions
    [c0, c0+cb) of ∂c/∂u for the requested sides, each (n, cb, B).

    ``as_rows=True`` returns, per side, the per-joint row list instead:
    ``rows[i]`` is ∂c_i/∂u_blk (cb, B), or ``None`` where the row is
    structurally zero (joint i outside ancestors ∪ subtree of the block) —
    the sparsity set the staged ∇FD finish contracts over.

    One forward loop computes ∂v_i, ∂a_i and ∂f_i together; joints outside
    the subtree of every block joint carry no nonzero ∂-column and are
    skipped (``None``). Equals columns [c0:c0+cb) of
    :func:`rnea_grad_inner_bl` up to the order of its sums."""
    n = model.n
    parents = model.topology.parents
    B = qd.shape[-1]
    dtype, device = qd.dtype, qd.device
    if cb is None:
        cb = n
    Ib = [_mat(model.inertia[i]) for i in range(n)]
    S_bl = [_col(model.S[i]) for i in range(n)]
    gcol = torch.arange(c0, c0 + cb, device=device)[None, :, None]  # (1,cb,1)

    def zeros_cols():
        return torch.zeros((6, cb, B), dtype=dtype, device=device)

    def sow(D, i, vec):
        """Add vec (6,B) into the column of D holding direction i, a joint
        of the block."""
        return D + (gcol == i).to(dtype) * vec[:, None]

    in_subtree = [False] * n
    for i in range(n):
        p = parents[i]
        in_subtree[i] = (c0 <= i < c0 + cb) or (p >= 0 and in_subtree[p])

    def one_side(side):
        is_q = side == "q"
        dv = [None] * n        # None ≡ identically zero
        da = [None] * n
        df = [None] * n
        for i in range(n):
            p = parents[i]
            if not in_subtree[i]:
                continue
            # the seeds enter only at a joint of the block
            in_block = c0 <= i < c0 + cb
            d = zeros_cols() if (p < 0 or dv[p] is None) \
                else matmat6(X[i], dv[p])
            if in_block:
                if is_q:
                    Xv = matvec6(X[i], v[p]) if p >= 0 \
                        else torch.zeros((6, B), dtype=dtype, device=device)
                    seed = -crm_apply_bl(S_bl[i], Xv)
                else:
                    seed = S_bl[i].expand(6, B)
                d = sow(d, i, seed)
            dv[i] = d

            d2 = zeros_cols() if (p < 0 or da[p] is None) \
                else matmat6(X[i], da[p])
            d2 = d2 - qd[i:i + 1][:, None] * crm_cols_left(S_bl[i], dv[i])
            if in_block:
                if is_q:
                    Xa = matvec6(X[i], a[p]) if p >= 0 \
                        else X[i][:, 5] * (-gravity)
                    seed2 = -crm_apply_bl(S_bl[i], Xa)
                else:
                    seed2 = -crm_apply_bl(S_bl[i], v[i])
                d2 = sow(d2, i, seed2)
            da[i] = d2

            Iv = matvec6(Ib[i], v[i])
            Idv = matmat6(Ib[i], dv[i])
            df[i] = (crf_cols_right(dv[i], Iv)
                     + crf_cols_left(v[i], Idv)
                     + matmat6(Ib[i], da[i]))

        for i in range(n - 1, -1, -1):
            p = parents[i]
            if p < 0:
                continue
            acc = df[p]
            if df[i] is not None:
                contrib = matmat6_T(X[i], df[i])
                acc = contrib if acc is None else acc + contrib
            if is_q and c0 <= i < c0 + cb:
                corr = matvec6_T(X[i], crf_apply_bl(S_bl[i], f[i]))
                acc = sow(zeros_cols() if acc is None else acc, i, corr)
            df[p] = acc

        rows = [sum(S_bl[i][r:r + 1] * df[i][r] for r in range(6))
                if df[i] is not None else None for i in range(n)]
        if not is_q:
            # damping on the global diagonal: row j gets damping_j at the
            # local column holding direction j
            for i in range(c0, min(c0 + cb, n)):
                d = (gcol[0] == i).to(dtype) * model.damping[i]
                d = d.expand(cb, B)
                rows[i] = d if rows[i] is None else rows[i] + d
        if as_rows:
            return rows
        return torch.stack([r if r is not None
                            else torch.zeros((cb, B), dtype=dtype,
                                             device=device)
                            for r in rows])

    return {side: one_side(side) for side in sides}
