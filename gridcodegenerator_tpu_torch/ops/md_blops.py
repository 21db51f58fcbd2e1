"""Batch-last plain PyTorch versions of the multi-dof kernel bodies.

The port's counterparts of the bodies in
``gridcodegenerator_tpu/ops/kernels/multidof_fused.py``, in the same
(1, B)-entry form and summation order, so the two agree at float64
round-off:

* :func:`md_transforms_bl` — X_i(q) per joint type (``_md_transforms_s``,
  ``_apply66``, multidof_fused.py:50-138);
* :func:`md_rnea_bl` — generalized RNEA (``_md_rnea_s``, :165-212);
* :func:`md_crba_bl` — generalized CRBA (``_md_crba_s``, :215-258);
* :func:`md_aba_bl` — generalized ABA with k×k Cholesky joint blocks
  (``_md_aba_body``, :285-368);
* :func:`md_id_grad_bl` — tangent-space ∂ID for a block of directions
  (all nv by default) as one (6, cb, B) tensor a joint, with the optional
  −M⁻¹·∂c finish (``_md_id_grad_cols_wide``, :576-740: the body of
  ``md_id_grad_fused`` and of the staged K5md blocks);
* :func:`md_fd_grad_bl` — tangent-space ∇FD, the Carpentier–Mansard
  pipeline (``_md_fd_grad_body``, :746-768);
* :func:`md_fd_crba_bl` — q̈ by CRBA and a dense Cholesky solve
  (``_md_fd_body``, :272);
* :func:`md_minv_bl`, :func:`md_minv_qdd_bl` — dense M⁻¹ and the explicit
  q̈ = M⁻¹(u − c) of the staged pipeline
  (``gridcodegenerator_tpu/ops/kernels/multidof_staged.py``, :127, :149).

Motion subspaces are folded as constants and their zeros skipped
(``model.S_np``), as the JAX bodies fold them at trace time. These are the
plain versions the CUDA kernels (``kernels/csrc/md.cuh``) are held to, and
the CPU branch of the wrappers in :mod:`.kernels.multidof_fused`.
"""

from __future__ import annotations

import torch

from . import blops
from .kernels.contact_fused import (_act_view, _chol_apply_e,
                                    _chol_factor_act, _chol_factor_ev,
                                    _chol_minv_sym, _chol_solve_act,
                                    _quat_rot_s, _sum_terms)


def _consts(model, B):
    """XT and the inertias broadcast to (n, 6, 6, B), damping and armature
    as (nv, 1): the JAX bodies' layout (a view, no copy)."""
    n = model.n
    return (model.XT[..., None].expand(n, 6, 6, B),
            model.inertia[..., None].expand(n, 6, 6, B),
            model.damping[:, None], model.armature[:, None])


def _S_cols(model, i):
    """Joint i's motion-subspace columns as float64 NumPy 6-vectors."""
    S = model.S_np[i]
    return [S[:, c] for c in range(model.v_slices[i][1])]


def _Smatvec(cols, coeffs):
    """Σ_c S[:, c]·x_c with S's columns folded as constants and (1,B)
    coefficients → (6,B); zero entries of S skipped."""
    rows = [_sum_terms([float(col[r]) * xc for col, xc in zip(cols, coeffs)
                        if col[r] != 0.0]) for r in range(6)]
    zero = torch.zeros_like(next(t for t in rows if t is not None))
    return torch.cat([t if t is not None else zero for t in rows])


def _vrows(x, model, i):
    """Joint i's velocity-coordinate rows of x (nv, B) as (1,B) slices."""
    sv, w = model.v_slices[i]
    return [x[sv + c:sv + c + 1] for c in range(w)]


# --------------------------------------------------------------------------
# joint transforms
# --------------------------------------------------------------------------
def _apply66(rows, XT, zero):
    """(6,6) list of (1,B)/None · (6,6,B) → (6,6,B): X = XJ·XT, the
    structural zeros of XJ skipped."""
    out = []
    for r in range(6):
        cols = [_sum_terms([rows[r][k] * XT[k, c:c + 1] for k in range(6)
                            if rows[r][k] is not None]) for c in range(6)]
        out.append(torch.cat([x if x is not None else zero for x in cols]))
    return torch.stack(out)


def md_transforms_bl(model, q):
    """q (nq, B) → list of n (6, 6, B) child ← parent transforms."""
    XT = _consts(model, q.shape[-1])[0]
    zero = torch.zeros_like(q[0:1])
    K_all, KK_all = model.rot_coeffs
    X = []
    for i in range(model.n):
        s, _ = model.q_slices[i]
        t = model.joint_types[i]
        rows = [[None] * 6 for _ in range(6)]
        if t in ("spherical", "floating"):
            R = _quat_rot_s(q[s:s + 4])
            E = [[R[c, r:r + 1] for c in range(3)] for r in range(3)]  # Rᵀ
            for r in range(6):
                for c in range(6):
                    if (r < 3) == (c < 3):
                        rows[r][c] = E[r % 3][c % 3]
            if t == "floating":
                # lower-left block −E·p̂ with p = q[s+4 : s+7]
                px, py, pz = q[s + 4:s + 5], q[s + 5:s + 6], q[s + 6:s + 7]
                P = [[None, -pz, py], [pz, None, -px], [-py, px, None]]
                for r in range(3):
                    for c in range(3):
                        rows[3 + r][c] = _sum_terms([
                            -E[r][k] * P[k][c] for k in range(3)
                            if P[k][c] is not None])
        else:
            qi = q[s:s + 1]
            K = K_all[i]
            if t == "prismatic":
                # XJ = I + q·[[0, 0], [−K, 0]]
                one = torch.ones_like(qi)
                for r in range(6):
                    rows[r][r] = one
                for r in range(3):
                    for c in range(3):
                        if K[r, c] != 0.0:
                            rows[3 + r][c] = -float(K[r, c]) * qi
            else:  # revolute: E = I − sin q·K + (1 − cos q)·K·K
                KK = KK_all[i]
                sn, cs = torch.sin(qi), torch.cos(qi)
                for r in range(3):
                    for c in range(3):
                        coeff = []
                        if r == c:
                            coeff.append(torch.ones_like(qi))
                        if K[r, c] != 0.0:
                            coeff.append(-float(K[r, c]) * sn)
                        if KK[r, c] != 0.0:
                            coeff.append(float(KK[r, c]) * (1.0 - cs))
                        e = _sum_terms(coeff)
                        rows[r][c] = e
                        rows[3 + r][3 + c] = e
        X.append(_apply66(rows, XT[i], zero))
    return X


# --------------------------------------------------------------------------
# RNEA, CRBA
# --------------------------------------------------------------------------
def md_rnea_bl(model, X, qd, qdd=None, gravity=-9.81):
    """Generalized RNEA on transforms X: → (c (nv, B), v, a, f), where v, a
    and f are lists of (6, B) and f is summed to the root."""
    parents = model.topology.parents
    n = model.n
    _, inertia, damping, armature = _consts(model, qd.shape[-1])
    minus_g = float(-gravity)
    v, a, f = [None] * n, [None] * n, [None] * n
    for i in range(n):
        p = parents[i]
        cols = _S_cols(model, i)
        vJ = _Smatvec(cols, _vrows(qd, model, i))
        v[i] = vJ if p < 0 else blops.matvec6(X[i], v[p]) + vJ
        ai = X[i][:, 5, :] * minus_g if p < 0 else blops.matvec6(X[i], a[p])
        ai = ai + blops.crm_apply_bl(v[i], vJ)
        if qdd is not None:
            ai = ai + _Smatvec(cols, _vrows(qdd, model, i))
        a[i] = ai
        Iv = blops.matvec6(inertia[i], v[i])
        f[i] = blops.matvec6(inertia[i], a[i]) + blops.crf_apply_bl(v[i], Iv)
    for i in range(n - 1, -1, -1):
        p = parents[i]
        if p >= 0:
            f[p] = f[p] + blops.matvec6_T(X[i], f[i])
    c_rows = []
    for i in range(n):
        sv, w = model.v_slices[i]
        for c, col in enumerate(_S_cols(model, i)):
            j = sv + c
            ci = _sum_terms([float(col[r]) * f[i][r:r + 1] for r in range(6)
                             if col[r] != 0.0])
            ci = ci + damping[j:j + 1] * qd[j:j + 1]
            if qdd is not None:
                ci = ci + armature[j:j + 1] * qdd[j:j + 1]
            c_rows.append(ci)
    return torch.cat(c_rows), v, a, f


def md_crba_bl(model, X):
    """Generalized CRBA → M as an (nv, nv) list of lists of (1,B) entries,
    None where two joints share no root path."""
    parents = model.topology.parents
    n, nv = model.n, model.nv
    _, inertia, _, armature = _consts(model, X[0].shape[-1])
    IC = [inertia[i] for i in range(n)]
    for i in range(n - 1, -1, -1):
        p = parents[i]
        if p >= 0:
            IC[p] = IC[p] + blops.matmat6_T(X[i], blops.matmat6(IC[i], X[i]))
    M = [[None] * nv for _ in range(nv)]
    for i in range(n):
        si, wi = model.v_slices[i]
        cols_i = _S_cols(model, i)
        F = [_sum_terms([float(col[k]) * IC[i][:, k] for k in range(6)
                         if col[k] != 0.0]) for col in cols_i]  # IC_i·S_i
        for ci in range(wi):
            for cj in range(ci + 1):
                val = _sum_terms([float(cols_i[cj][r]) * F[ci][r:r + 1]
                                  for r in range(6) if cols_i[cj][r] != 0.0])
                if ci == cj:
                    val = val + armature[si + ci:si + ci + 1]
                M[si + ci][si + cj] = val
                M[si + cj][si + ci] = val
        j = i
        while parents[j] >= 0:
            F = [blops.matvec6_T(X[j], Fc) for Fc in F]
            j = parents[j]
            sj, wj = model.v_slices[j]
            cols_j = _S_cols(model, j)
            for ci in range(wi):
                for cj in range(wj):
                    val = _sum_terms([float(cols_j[cj][r]) * F[ci][r:r + 1]
                                      for r in range(6)
                                      if cols_j[cj][r] != 0.0])
                    M[si + ci][sj + cj] = val
                    M[sj + cj][si + ci] = val
    return M


# --------------------------------------------------------------------------
# ABA
# --------------------------------------------------------------------------
def md_aba_bl(model, q, qd, u, gravity=-9.81):
    """Generalized articulated-body FD: q̈ (nv, B), each joint's
    D = SᵀIᴬS + diag(armature) a k×k block solved by its entry Cholesky."""
    parents = model.topology.parents
    n = model.n
    _, inertia, damping, armature = _consts(model, q.shape[-1])
    X = md_transforms_bl(model, q)
    minus_g = float(-gravity)

    v, zeta = [None] * n, [None] * n
    for i in range(n):
        p = parents[i]
        vJ = _Smatvec(_S_cols(model, i), _vrows(qd, model, i))
        v[i] = vJ if p < 0 else blops.matvec6(X[i], v[p]) + vJ
        zeta[i] = blops.crm_apply_bl(v[i], vJ)
    IA = [inertia[i] for i in range(n)]
    pA = [blops.crf_apply_bl(v[i], blops.matvec6(inertia[i], v[i]))
          for i in range(n)]

    U, Lc, ub = [None] * n, [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        sv, w = model.v_slices[i]
        cols = _S_cols(model, i)
        Ucols = [_sum_terms([float(col[k]) * IA[i][:, k] for k in range(6)
                             if col[k] != 0.0]) for col in cols]
        D = [[_sum_terms([float(cols[cj][r]) * Ucols[ci][r:r + 1]
                          for r in range(6) if cols[cj][r] != 0.0])
              for cj in range(w)] for ci in range(w)]
        for c in range(w):
            D[c][c] = D[c][c] + armature[sv + c:sv + c + 1]
        L = _chol_factor_ev(D, w)
        ubar = []
        for c in range(w):
            SpA = _sum_terms([float(cols[c][r]) * pA[i][r:r + 1]
                              for r in range(6) if cols[c][r] != 0.0])
            ubar.append(u[sv + c:sv + c + 1]
                        - damping[sv + c:sv + c + 1] * qd[sv + c:sv + c + 1]
                        - SpA)
        U[i], Lc[i], ub[i] = Ucols, L, ubar
        # W[r] = D⁻¹·Uᵀ[:, r]; (U D⁻¹ Uᵀ)[r, k] = Σ_c U[r, c]·W[k][c]
        W = [_chol_apply_e(L, [Ucols[c][r:r + 1] for c in range(w)])
             for r in range(6)]
        UDU = torch.stack([
            torch.cat([_sum_terms([Ucols[c][r:r + 1] * W[k][c]
                                   for c in range(w)]) for k in range(6)])
            for r in range(6)])
        Ia = IA[i] - UDU
        Dinv_u = _chol_apply_e(L, ubar)
        pa = (pA[i] + blops.matvec6(Ia, zeta[i])
              + sum(Ucols[c] * Dinv_u[c] for c in range(w)))
        p = parents[i]
        if p >= 0:
            IaX = sum(Ia[:, c][:, None] * X[i][c][None] for c in range(6))
            XIaX = sum(X[i][c][:, None] * IaX[c][None] for c in range(6))
            IA[p] = IA[p] + XIaX
            pA[p] = pA[p] + blops.matvec6_T(X[i], pa)

    a = [None] * n
    qdd_rows = [None] * model.nv
    for i in range(n):
        p = parents[i]
        if p < 0:
            a_prime = X[i][:, 5, :] * minus_g + zeta[i]
        else:
            a_prime = blops.matvec6(X[i], a[p]) + zeta[i]
        sv, w = model.v_slices[i]
        rhs = [ub[i][c] - _sum_terms([U[i][c][r:r + 1] * a_prime[r:r + 1]
                                      for r in range(6)]) for c in range(w)]
        qdd_i = _chol_apply_e(Lc[i], rhs)
        qdd_rows[sv:sv + w] = qdd_i
        a[i] = a_prime + _Smatvec(_S_cols(model, i), qdd_i)
    return torch.cat(qdd_rows)


# --------------------------------------------------------------------------
# tangent-space ∂ID and ∇FD
# --------------------------------------------------------------------------
def _span(model, i, c0, cb):
    """Joint i's directions inside the column block [c0, c0 + cb): (js,
    je), empty when js ≥ je. A block may cut a ball or free joint's
    directions."""
    sv, w = model.v_slices[i]
    return max(sv, c0), min(sv + w, c0 + cb)


def _S_wide(model, i, like, js, je):
    """Joint i's S columns js..je−1 (global directions) as (6, je − js, B)
    values (constants times ones)."""
    S = model.S_np[i][:, js - model.v_slices[i][0]:je - model.v_slices[i][0]]
    zero = torch.zeros_like(like[0:1])[:, None]
    return torch.cat([torch.cat([zero + float(S[r, k]) if S[r, k] != 0.0
                                 else zero for k in range(je - js)], dim=1)
                      for r in range(6)])


def _insert(seed_w, js, je, c0, cb):
    """(6, je − js, B) seeds of directions js..je−1 → (6, cb, B) at their
    columns of the block [c0, c0 + cb), zero in the others."""
    rest = seed_w.shape[2:]
    parts = []
    if js > c0:
        parts.append(seed_w.new_zeros((6, js - c0) + rest))
    parts.append(seed_w)
    if c0 + cb > je:
        parts.append(seed_w.new_zeros((6, c0 + cb - je) + rest))
    return torch.cat(parts, dim=1)


def md_id_grad_bl(model, X, qd, v, a, f, gravity=-9.81, sides=("q", "qd"),
                  c0=0, cb=None, minv=None):
    """Tangent-space ∂ID at the sweep (v, a, f) (f summed to the root) for
    the directions [c0, c0 + cb) (all nv by default), the block's columns
    as one (6, cb, B) tensor a joint: → per side an (nv, cb, B) block of
    ∂τ/∂δq or ∂τ/∂q̇ (damping on the block's diagonal entries), or with
    ``minv`` (nv, nv, B) the finish −M⁻¹·∂τ over the structurally nonzero
    rows, in ascending order.

    Seeds in the columns of the directions a joint owns: crm(X_j·v_p)·S_j
    and crm(X_j·a_p)·S_j on the q side (a root's a_p is −g), S_j and
    crm(v_j)·S_j on the q̇ side; the backward pass adds crf(S_j)·f_j on the
    q side for non-root joints. Joints outside the subtree of the block's
    owners are skipped forward; their ancestors still take ∂f backward.
    The JAX body is ``_md_id_grad_cols_wide`` (multidof_fused.py:576)."""
    parents = model.topology.parents
    n, nv = model.n, model.nv
    cb = nv - c0 if cb is None else cb
    B = qd.shape[-1]
    _, inertia, damping, _ = _consts(model, B)
    minus_g = float(-gravity)
    span = [_span(model, i, c0, cb) for i in range(n)]
    owns = [js < je for js, je in span]
    in_sub = [False] * n
    for i in range(n):
        p = parents[i]
        in_sub[i] = owns[i] or (p >= 0 and in_sub[p])
    outs = {}
    for side in sides:
        is_q = side == "q"
        DV, DA, DF = [None] * n, [None] * n, [None] * n
        for i in range(n):
            if not in_sub[i]:
                continue
            p = parents[i]
            dv = (None if p < 0 or DV[p] is None
                  else blops.matmat6(X[i], DV[p]))
            da = (None if p < 0 or DA[p] is None
                  else blops.matmat6(X[i], DA[p]))
            if owns[i]:
                js, je = span[i]
                if is_q:
                    Xv = blops.matvec6(X[i], v[p]) if p >= 0 else None
                    Xa = (blops.matvec6(X[i], a[p]) if p >= 0
                          else X[i][:, 5, :] * minus_g)
                    Sw = _S_wide(model, i, Xa, js, je)
                    if Xv is not None:
                        seed = _insert(blops.crm_cols_left(Xv, Sw), js, je,
                                       c0, cb)
                        dv = seed if dv is None else dv + seed
                    da_seed = _insert(blops.crm_cols_left(Xa, Sw), js, je,
                                      c0, cb)
                else:
                    Sw = _S_wide(model, i, v[i], js, je)
                    seed = _insert(Sw, js, je, c0, cb)
                    dv = seed if dv is None else dv + seed
                    da_seed = _insert(blops.crm_cols_left(v[i], Sw), js, je,
                                      c0, cb)
                da = da_seed if da is None else da + da_seed
            if dv is not None:
                vJ = _Smatvec(_S_cols(model, i), _vrows(qd, model, i))
                term = -blops.crm_cols_left(vJ, dv)
                da = term if da is None else da + term
            df = None if da is None else blops.matmat6(inertia[i], da)
            if dv is not None:
                Iv = blops.matvec6(inertia[i], v[i])
                t = (blops.crf_cols_right(dv, Iv)
                     + blops.crf_cols_left(v[i],
                                           blops.matmat6(inertia[i], dv)))
                df = t if df is None else df + t
            DV[i], DA[i], DF[i] = dv, da, df

        for i in range(n - 1, -1, -1):
            p = parents[i]
            if p < 0:
                continue
            acc = DF[i]
            if is_q and owns[i]:
                js, je = span[i]
                Sw = _S_wide(model, i, f[i], js, je)
                corr = _insert(blops.crf_cols_right(Sw, f[i]), js, je, c0,
                               cb)
                acc = corr if acc is None else acc + corr
            if acc is not None:
                up = blops.matmat6_T(X[i], acc)
                DF[p] = up if DF[p] is None else DF[p] + up

        rows = [None] * nv
        for i in range(n):
            if DF[i] is None:
                continue
            sv, w = model.v_slices[i]
            S = model.S_np[i]
            for c in range(w):
                rows[sv + c] = sum(float(S[r, c]) * DF[i][r]
                                   for r in range(6) if S[r, c] != 0.0)
        if not is_q:
            one = torch.ones_like(qd[0:1])
            for jd in range(c0, c0 + cb):
                d1 = (damping[jd:jd + 1] * one)[:, None]        # (1, 1, B)
                parts = []
                if jd > c0:
                    parts.append(one.new_zeros((1, jd - c0, B)))
                parts.append(d1)
                if c0 + cb > jd + 1:
                    parts.append(one.new_zeros((1, c0 + cb - jd - 1, B)))
                dmask = torch.cat(parts, dim=1)[0]
                rows[jd] = dmask if rows[jd] is None else rows[jd] + dmask
        if minv is None:
            zero = qd.new_zeros((cb, B))
            outs[side] = torch.stack([r if r is not None else zero
                                      for r in rows])
        else:
            acc = None
            for r in range(nv):
                if rows[r] is None:
                    continue
                t = minv[r][:, None] * rows[r][None]
                acc = t if acc is None else acc + t
            outs[side] = -acc
    return tuple(outs[s] for s in sides)


# --------------------------------------------------------------------------
# CRBA forward dynamics and the staged pipeline's M⁻¹ stages
# --------------------------------------------------------------------------
def md_fd_crba_bl(model, q, qd, u, gravity=-9.81):
    """Forward dynamics by the mass matrix: bias RNEA, CRBA, active-region
    Cholesky and one single-rhs solve → q̈ (nv, B) (JAX ``_md_fd_body``,
    multidof_fused.py:272)."""
    nv = model.nv
    X = md_transforms_bl(model, q)
    c, *_ = md_rnea_bl(model, X, qd, None, gravity)
    L = _chol_factor_ev(md_crba_bl(model, X), nv)
    return torch.cat(_chol_apply_e(L, [u[r:r + 1] - c[r:r + 1]
                                       for r in range(nv)]))


def md_minv_bl(model, X):
    """Dense symmetric M⁻¹ (nv, nv, B): CRBA, the active-region factor and
    L⁻ᵀ·L⁻¹ (the body of JAX ``md_minv_fused``, multidof_staged.py:127)."""
    nv = model.nv
    return _chol_minv_sym(_chol_factor_act(md_crba_bl(model, X), nv), nv)


def md_minv_qdd_bl(model, q, qd, u, gravity=-9.81):
    """(M⁻¹ (nv, nv, B), q̈ (nv, B)) with q̈ = Σ_j M⁻¹[:, j]·(u − c)[j], the
    explicit product in ascending j (JAX ``md_minv_qdd_fused``,
    multidof_staged.py:149), not the Cholesky solve of
    :func:`md_fd_crba_bl`."""
    X = md_transforms_bl(model, q)
    c, *_ = md_rnea_bl(model, X, qd, None, gravity)
    Minv = md_minv_bl(model, X)
    rhs = u - c
    return Minv, sum(Minv[:, j] * rhs[j:j + 1] for j in range(model.nv))


def md_fd_grad_bl(model, q, qd, u, gravity=-9.81):
    """Tangent-space ∇FD: bias RNEA → CRBA → active-region Cholesky → q̈ →
    (v, a, f) at q̈ → ∂ID → −M⁻¹·∂c, and M⁻¹ = L⁻ᵀL⁻¹. Returns (∂q̈/∂δq,
    ∂q̈/∂q̇, ∂q̈/∂u), each (nv, nv, B)."""
    nv = model.nv
    X = md_transforms_bl(model, q)
    c, *_ = md_rnea_bl(model, X, qd, None, gravity)
    cols = _chol_factor_act(md_crba_bl(model, X), nv)
    qdd = torch.cat(_chol_apply_e(_act_view(cols, nv),
                                  [u[r:r + 1] - c[r:r + 1]
                                   for r in range(nv)]))
    _, v, a, f = md_rnea_bl(model, X, qd, qdd, gravity)
    Dq, Dqd = md_id_grad_bl(model, X, qd, v, a, f, gravity)
    return (-_chol_solve_act(cols, Dq), -_chol_solve_act(cols, Dqd),
            _chol_minv_sym(cols, nv))
