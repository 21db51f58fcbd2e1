"""The floating-base kernels and their plain versions, in batch-last
PyTorch.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/
contact_fused.py``. It holds

* the dense factor helpers that the staged large-robot pipeline
  (:mod:`.staged`) and the multi-dof bodies (:mod:`..md_blops`) use too:
  the active-region column Cholesky of an ancestor-sparse matrix
  (:func:`_chol_factor_act`, with the Delassus ``reg``), the symmetric
  inverse from it (:func:`_chol_minv_sym`), the multi-rhs solve
  (:func:`_chol_solve_act`), the entry-view factor and its solve
  (:func:`_act_view`, :func:`_chol_factor_ev`, :func:`_chol_apply_e`) and
  :func:`_sum_terms`;
* the small-geometry helpers (:func:`_cross3s`, :func:`_mv3s`,
  :func:`_mm33s`, the quaternion's rotation and product, :func:`_fk_s`),
  the free-flyer bias and mass matrix (:func:`_fb_bias_s`,
  :func:`_fb_mass_s`) and the contact rows (:func:`_ff_contact_rows_s`);
* the bodies of five TPU kernels with their plain versions and wrappers:
  ``fb_aba_fused`` (contact_fused.py:1413, the floating-base ABA),
  ``fb_fd_fused`` (:1329, the (6+n)² mass matrix and its Cholesky solve),
  ``stance_fd_fused`` (:1431, stance-constrained FD through the Delassus
  matrix), and ``step_ground_fused`` (:1458) and
  ``step_ground_terrain_fused`` (:1531), one frictional ground step on the
  plane or a heightfield (the plain version :func:`step_ground_plain`, the
  JAX ``_step_ground_body`` (:977) whole: the feet, push and softness; PGS
  on the friction cones and the closures' bilateral rows,
  :func:`_pgs_rows`; the heightfield's frames, :func:`_ground_rows`; the
  ground geoms' rows, :func:`_ground_geom_rows`; the self-collision and
  obstacle rows, :func:`collision_static` and :func:`_collision_rows_s`,
  whose geometry helpers — the JAX ``_seg_seg_closest_s``,
  ``_pair_geometry_s``, ``_frame_rows_s`` and ``_point_cols_s`` — are
  :mod:`..collision`'s batch-last ones, one copy; the loop closures'
  rows, :func:`loops_static` and :func:`_loop_rows_s`; the attitude
  update, :func:`_quat_exp_s`).

Entries are (1, B) tensors, ``None`` where structurally zero; every sum
runs left to right, the order the CUDA kernels (``csrc/chol.cuh``,
``staged.cuh``, ``md.cuh``, ``ff.cuh``) keep. Each wrapper runs its plain
version on CPU tensors and its kernel (``csrc/ff.cu``, built for the arm's
topology, and for the stance kernel the contact links, at first use) on
CUDA tensors, with no fallback from one to the other. The step kernel
is built per set of feet, ground-geom, collision and loop links; all
geometry is a run-time argument. The JAX package's
lane-budget gates (``ff_workset_ok``, ``fb_aba_fused``'s test,
``terrain_fused_ok``) and its XLA fallback fit a TPU tile; here one thread
holds one state at every size, and the height grid stays in device
memory, so every grid runs the kernel. The TPU kernel's one-hot matmul
gather of a foot's four grid nodes is an index gather here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import blops
from .. import collision as _col
from .. import terrain as _terrain
from ..so import jvp
from ._launch import check_ff, empty, launch, on_cpu, ptr


def _sum_terms(terms):
    """Sum a list of (1,B) terms left to right, skipping Nones; None if all
    are None."""
    live = [t for t in terms if t is not None]
    if not live:
        return None
    s = live[0]
    for t in live[1:]:
        s = s + t
    return s


def _quat_rot_s(quat):
    """(4,B) unit quaternions → (3,3,B) rotations, all products on (1,B)
    slices; the quaternion is not normalised."""
    w, x, y, z = quat[0:1], quat[1:2], quat[2:3], quat[3:4]
    one = 1.0
    rows = [
        torch.cat([one - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)]),
        torch.cat([2 * (x * y + w * z), one - 2 * (x * x + z * z),
                   2 * (y * z - w * x)]),
        torch.cat([2 * (x * z - w * y), 2 * (y * z + w * x),
                   one - 2 * (x * x + y * y)]),
    ]
    return torch.stack(rows)


def _chol_apply_e(L, r):
    """Solve (L Lᵀ) x = r with L an entry view (``L[i][j]`` a (1,B) entry or
    None) and r a list of m (1,B)/None entries: forward, then back
    substitution, each row's terms summed in ascending order."""
    m = len(L)
    y = [None] * m
    for i in range(m):
        terms = [r[i]] if r[i] is not None else []
        terms.extend(-L[i][p] * y[p] for p in range(i)
                     if L[i][p] is not None and y[p] is not None)
        s = _sum_terms(terms)
        y[i] = (s / L[i][i]) if s is not None else None
    x = [None] * m
    for i in reversed(range(m)):
        terms = [y[i]] if y[i] is not None else []
        terms.extend(-L[p][i] * x[p] for p in range(i + 1, m)
                     if L[p][i] is not None and x[p] is not None)
        s = _sum_terms(terms)
        x[i] = (s / L[i][i]) if s is not None else None
    return x


def _chol_factor_act(M, m, reg=0.0):
    """Left-looking column Cholesky of an m×m list of lists of (1,B)/None
    entries, restricted to the active region: ``cols[j]`` is the (m−j, B)
    stack of rows j..m−1 of L's column j (``cols[j][0:1]`` is the
    diagonal). ``reg`` adds Tikhonov mass to each diagonal entry before its
    column update (the Delassus factor's guard against a singular
    stance)."""
    zero = next(torch.zeros_like(e) for row in M for e in row
                if e is not None)
    cols = []
    for j in range(m):
        c = torch.cat([zero if M[i][j] is None else M[i][j]
                       for i in range(j, m)])                  # (m-j, B)
        if reg:
            c = torch.cat([c[0:1] + reg, c[1:]])
        for p in range(j):
            # L[j:, p] = cols[p][j-p:], L[j, p] = cols[p][j-p : j-p+1]
            c = c - cols[p][j - p:] * cols[p][j - p:j - p + 1]
        cols.append(c / torch.sqrt(c[0:1]))
    return cols


def _act_view(cols, m):
    """Active columns → the entry view ``L[i][j]`` ((1,B), None above the
    diagonal) that :func:`_chol_apply_e` reads."""
    return [[cols[j][i - j:i - j + 1] if j <= i else None
             for j in range(m)] for i in range(m)]


def _chol_factor_ev(M, m):
    """The entry view of :func:`_chol_factor_act`'s factor of M."""
    return _act_view(_chol_factor_act(M, m), m)


def _chol_solve_act(cols, Bmat):
    """Solve (L Lᵀ) X = B for a wide right-hand side B (m, k, B) with the
    active column factor of :func:`_chol_factor_act`: column-oriented
    forward and back substitution, one (m−j, k, B) update per column."""
    m = len(cols)
    X = Bmat.clone()
    for j in range(m):
        X[j] = X[j] / cols[j][0:1]
        if j + 1 < m:
            X[j + 1:] = X[j + 1:] - cols[j][1:][:, None] * X[j][None]
    for j in reversed(range(m)):
        if j + 1 < m:
            corr = sum(cols[j][r - j:r - j + 1] * X[r]
                       for r in range(j + 1, m))
            X[j] = (X[j] - corr) / cols[j][0:1]
        else:
            X[j] = X[j] / cols[j][0:1]
    return X


def _chol_minv_sym(cols, m):
    """Dense symmetric inverse (m, m, B) from the active column factor:
    M⁻¹ = L⁻ᵀ·L⁻¹ with both stages restricted to their triangles. Y = L⁻¹
    is built column by column (at step j only columns ≤ j of the rows
    below change); then column j of M⁻¹ on and above the diagonal is
    Σ_{p≥j} Y[p, :j+1]·Y[p, j] (summed for p = j, j+1, …), mirrored into
    the lower triangle."""
    B = cols[0].shape[-1]
    Y = torch.eye(m, dtype=cols[0].dtype, device=cols[0].device)
    Y = Y[:, :, None].expand(m, m, B).clone()
    for j in range(m):
        Y[j, :j + 1] = Y[j, :j + 1] / cols[j][0:1]
        if j + 1 < m:
            Y[j + 1:, :j + 1] = (Y[j + 1:, :j + 1]
                                 - cols[j][1:][:, None] * Y[j, :j + 1][None])
    out = torch.empty_like(Y)
    for j in range(m):
        colj = sum(Y[p, :j + 1] * Y[p, j:j + 1] for p in range(j, m))
        out[:j + 1, j] = colj
        out[j, :j] = colj[:j]
    return out


# --------------------------------------------------------------------------
# small-geometry helpers, (1,B)-entry style
# --------------------------------------------------------------------------
def _cross3s(a, b):
    """(3,B) × (3,B) → (3,B) on (1,B) slices."""
    return torch.cat([
        a[1:2] * b[2:3] - a[2:3] * b[1:2],
        a[2:3] * b[0:1] - a[0:1] * b[2:3],
        a[0:1] * b[1:2] - a[1:2] * b[0:1],
    ])


def _mv3s(A, x, tA=False):
    """(3,3,B) @ (3,B) → (3,B): Σ_k A[:, k]·x_k (Aᵀ's columns with
    ``tA``)."""
    col = (lambda k: A[k]) if tA else (lambda k: A[:, k])
    return sum(col(k) * x[k:k + 1] for k in range(3))


def _mv3s_c(A, c):
    """(3,3,B) @ a constant 3-vector (Python floats) → (3,B), the zero
    components skipped (JAX ``_mv3s_c``, :475)."""
    return torch.cat([
        sum(A[i, j:j + 1] * c[j] for j in range(3) if c[j] != 0.0)
        if any(c[j] != 0.0 for j in range(3)) else A[i, 0:1] * 0.0
        for i in range(3)])


def _mtv3s_c(A, c):
    """Aᵀ (3,3,B) @ a constant 3-vector (Python floats) → (3,B), the zero
    components skipped (JAX ``_mtv3s_c``, :485)."""
    return torch.cat([
        sum(A[j, i:i + 1] * c[j] for j in range(3) if c[j] != 0.0)
        if any(c[j] != 0.0 for j in range(3)) else A[0, i:i + 1] * 0.0
        for i in range(3)])


def _mm33s(A, B, tA=False, tB=False):
    """(3,3,B) @ (3,3,B) → (3,3,B): out[:, j] = Σ_k A[:, k]·B[k, j], with
    either operand transposed."""
    acol = (lambda k: A[k]) if tA else (lambda k: A[:, k])
    bent = (lambda k, j: B[j, k:k + 1]) if tB else (
        lambda k, j: B[k, j:j + 1])
    cols = [sum(acol(k) * bent(k, j) for k in range(3)) for j in range(3)]
    return torch.stack(cols, dim=1)


def _quat_mul_s(a, b):
    """(4,B) ⊗ (4,B) → (4,B), (w, x, y, z)."""
    aw, ax, ay, az = a[0:1], a[1:2], a[2:3], a[3:4]
    bw, bx, by, bz = b[0:1], b[1:2], b[2:3], b[3:4]
    return torch.cat([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
    ])


def _support(topo, links):
    """The joints the contact rows of ``links`` depend on, ascending:
    ∪ ancestors(link) ∪ {link}."""
    return sorted(set().union(*(set(topo.ancestors[l]) | {l}
                                for l in links)))


def _fk_s(model, X, joints):
    """World poses of the links ``joints`` (ascending, closed under
    ancestors) from their transforms: X (list of (6,6,B)) → (Rs list of
    (3,3,B) world ← link, ps list of (3,B)), None for the other links; the
    root joints' Rs is Eᵀ directly (no identity product)."""
    n = model.n
    Rs = [None] * n
    ps = [None] * n
    for i in joints:
        E = X[i][:3, :3]                       # child ← parent
        Xl = X[i][3:, :3]
        # r = unskew(−Eᵀ·Xl), from the three entries of Eᵀ·Xl it reads
        r = -torch.cat([sum(E[k, a:a + 1] * Xl[k, b:b + 1] for k in range(3))
                        for a, b in ((2, 1), (0, 2), (1, 0))])
        p = model.topology.parents[i]
        if p < 0:
            Rs[i] = torch.stack([torch.cat([E[j, i2:i2 + 1]
                                            for j in range(3)])
                                 for i2 in range(3)])
            ps[i] = r
        else:
            Rs[i] = _mm33s(Rs[p], E, tB=True)  # R_p @ Eᵀ
            ps[i] = ps[p] + _mv3s(Rs[p], r)
    return Rs, ps


# --------------------------------------------------------------------------
# the free-flyer bias and mass matrix
# --------------------------------------------------------------------------
def _arm_consts(ffm, B):
    """The arm's inertias (n, 6, 6, B) and the base inertia (6, 6, B),
    expanded to the batch (views), and S (n, 6, 1)."""
    n = ffm.n
    return (ffm.arm.inertia[..., None].expand(n, 6, 6, B),
            ffm.I_base[..., None].expand(6, 6, B), ffm.arm.S[..., None])


def _a0_lin(R, gravity):
    """−g_b = −g·R[2, :]: the linear part of the fictitious base
    acceleration a₀' = [0; −g_b] (the gravity trick)."""
    g = float(gravity)
    return torch.cat([-g * R[2, i:i + 1] for i in range(3)])


def _fb_bias_s(ffm, X, R, vb, qd, gravity):
    """Bias forces at q̈ = 0 with a₀' as the base acceleration: → (f_b
    (6,B), c_j (n,B)), the base wrench and joint torques (JAX
    ``_fb_bias_s``, :153). a₀' enters structurally (its zero angular rows
    are never formed)."""
    n = ffm.n
    parents = ffm.arm.topology.parents
    inertia, I_base, S = _arm_consts(ffm, vb.shape[-1])
    a0_lin = _a0_lin(R, gravity)

    def x_dot_a0(Xi):
        # X·a₀' with a₀' = [0, 0, 0 | a0_lin]: the linear columns only
        return sum(Xi[:, 3 + c] * a0_lin[c:c + 1] for c in range(3))

    v = [None] * n
    a = [None] * n
    f = [None] * n
    for i in range(n):
        p = parents[i]
        Sqd = S[i] * qd[i:i + 1]
        v[i] = blops.matvec6(X[i], vb if p < 0 else v[p]) + Sqd
        ai = x_dot_a0(X[i]) if p < 0 else blops.matvec6(X[i], a[p])
        a[i] = ai + blops.crm_apply_bl(v[i], Sqd)
        Iv = blops.matvec6(inertia[i], v[i])
        f[i] = blops.matvec6(inertia[i], a[i]) + blops.crf_apply_bl(v[i], Iv)
    Ivb = blops.matvec6(I_base, vb)
    f_b = (sum(I_base[:, 3 + c] * a0_lin[c:c + 1] for c in range(3))
           + blops.crf_apply_bl(vb, Ivb))
    for i in range(n - 1, -1, -1):
        p = parents[i]
        if p >= 0:
            f[p] = f[p] + blops.matvec6_T(X[i], f[i])
        else:
            f_b = f_b + blops.matvec6_T(X[i], f[i])
    c_j = [sum(S[i][c:c + 1] * f[i][c:c + 1] for c in range(6))
           + ffm.arm.damping[i] * qd[i:i + 1] for i in range(n)]
    return f_b, torch.cat(c_j)


def _fb_mass_s(ffm, X):
    """The (6+n)² free-flyer mass matrix by composite inertias with the
    base as a 6-dof joint (JAX ``_fb_mass_s``, :197): a list of lists of
    (1,B) entries, ``None`` where joint pairs have no ancestor relation."""
    n = ffm.n
    parents = ffm.arm.topology.parents
    inertia, IC_b, S = _arm_consts(ffm, X[0].shape[-1])
    IC = list(inertia)
    for i in range(n - 1, -1, -1):
        p = parents[i]
        contrib = blops.matmat6_T(X[i], blops.matmat6(IC[i], X[i]))
        if p >= 0:
            IC[p] = IC[p] + contrib
        else:
            IC_b = IC_b + contrib
    m = 6 + n
    E = [[None] * m for _ in range(m)]
    for r in range(6):
        for c in range(6):
            E[r][c] = IC_b[r, c:c + 1]
    for i in range(n):
        F = blops.matvec6(IC[i], S[i])
        # + armature on the joint diagonal (the free base has no motor)
        E[6 + i][6 + i] = (sum(S[i][c:c + 1] * F[c:c + 1] for c in range(6))
                           + ffm.arm.armature[i])
        j = i
        while parents[j] >= 0:
            F = blops.matvec6_T(X[j], F)
            j = parents[j]
            val = sum(F[c:c + 1] * S[j][c:c + 1] for c in range(6))
            E[6 + i][6 + j] = val
            E[6 + j][6 + i] = val
        F = blops.matvec6_T(X[j], F)                # into base coordinates
        for c in range(6):
            E[6 + i][c] = F[c:c + 1]
            E[c][6 + i] = F[c:c + 1]
    return E


# --------------------------------------------------------------------------
# contact rows
# --------------------------------------------------------------------------
def _stack_rows(entries, like):
    """A list of (1,B)/None entries → one (R,B) tensor, None as zero."""
    zero = torch.zeros_like(like)
    return torch.cat([e if e is not None else zero for e in entries])


def _dense_rows(J, m, like):
    """Rows (R lists of m (1,B)/None entries) → one (R, m, B) tensor, None
    as zero."""
    zero = torch.zeros((len(J), like.shape[-1]), dtype=like.dtype,
                       device=like.device)
    return torch.stack([zero if c is None else c
                        for c in _jt_stacks(J, m, like)], dim=1)


def _jt_stacks(J, m, like):
    """Contact rows (3k lists of m (1,B)/None entries) → per column, the
    (3k,B) stack of J[r][c] over the rows, or None for a column outside
    every contact's support."""
    JT = []
    for c in range(m):
        ent = [J[r][c] for r in range(len(J))]
        JT.append(None if all(e is None for e in ent)
                  else _stack_rows(ent, like))
    return JT


def _omega_cols(R, x):
    """The ω_b columns R·(e_j × x) of a point x (3,B) in base coordinates,
    j = 0, 1, 2: e_0 × x = (0, −x2, x1), e_1 × x = (x2, 0, −x0), e_2 × x =
    (−x1, x0, 0)."""
    zero1 = x[0:1] * 0.0
    ex = [torch.cat([zero1, -x[2:3], x[1:2]]),
          torch.cat([x[2:3], zero1, -x[0:1]]),
          torch.cat([-x[1:2], x[0:1], zero1])]
    return [_mv3s(R, e) for e in ex]


def _point_rows(ffm, R, Rs, ps, l, x_b):
    """The three world-frame linear rows of a point x_b (3,B) in base
    coordinates, rigidly attached to link ``l`` (−1: the base), over the
    6+n columns [ω_b; v_b; q̇]: (1,B) entries, None outside ancestors(l) ∪
    {l}. The ω_b columns are R·(e_j × x_b), the v_b columns R[:, j], a
    joint's column R·(a_ang × (x_b − p_j) + a_lin)."""
    wcols = _omega_cols(R, x_b)
    acols = {j: _mv3s(R, c)
             for j, c in _col._arm_point_jac_bl(ffm, Rs, ps, l, x_b).items()}
    rows = []
    for r in range(3):
        row = [None] * (6 + ffm.n)
        for j in range(3):
            row[j] = wcols[j][r:r + 1]
        for j in range(3):
            row[3 + j] = R[r, j:j + 1]
        for j, col in acols.items():
            row[6 + j] = col[r:r + 1]
        rows.append(row)
    return rows


def _ff_contact_rows_s(ffm, X, R, links, offsets, fk=None):
    """World-frame linear rows of the k contact points (JAX
    ``_ff_contact_rows_s``, :426): 3k lists over the 6+n columns [ω_b; v_b;
    q̇] of (1,B)/None entries (:func:`_point_rows`), and the points in base
    coordinates x_b (k (3,B)). X is read on the links' support only; ``fk``
    = (Rs, ps) of :func:`_fk_s` where the caller has them."""
    Rs, ps = fk or _fk_s(ffm.arm, X, _support(ffm.arm.topology, links))
    rows, xs = [], []
    for ci, l in enumerate(links):
        off = [float(offsets[ci][d]) for d in range(3)]
        x_b = ps[l] + torch.cat([sum(Rs[l][i, j:j + 1] * off[j]
                                     for j in range(3)) for i in range(3)])
        xs.append(x_b)
        rows.extend(_point_rows(ffm, R, Rs, ps, l, x_b))
    return rows, xs


# --------------------------------------------------------------------------
# the kernels' plain versions (any device): quat (4,B), pos (3,B), q, q̇, τ
# (n,B), vb (6,B)
# --------------------------------------------------------------------------
def _rhs_free(f_b, c_j, tau, push=None):
    """[−f_b; τ − c_j] as m (1,B) entries; with an external base wrench
    ``push`` (6,B), [push − f_b; τ − c_j]."""
    base = ([-f_b[c:c + 1] for c in range(6)] if push is None
            else [push[c:c + 1] - f_b[c:c + 1] for c in range(6)])
    return base + [tau[i:i + 1] - c_j[i:i + 1] for i in range(tau.shape[0])]


def fb_fd_plain(ffm, quat, q, vb, qd, tau, gravity=-9.81):
    """Unconstrained free-flyer FD by the mass matrix (JAX ``_fb_fd_body``,
    :1310): the bias, the (6+n)² mass matrix, its Cholesky factor and one
    solve → (v̇b (6,B), q̈ (n,B))."""
    X = blops.joint_transforms_bl(ffm.arm, q)
    R = _quat_rot_s(quat)
    f_b, c_j = _fb_bias_s(ffm, X, R, vb, qd, gravity)
    M = _fb_mass_s(ffm, X)
    y = _chol_apply_e(_chol_factor_ev(M, 6 + ffm.n), _rhs_free(f_b, c_j, tau))
    return torch.cat(y[:6]), torch.cat(y[6:])


def fb_aba_plain(ffm, quat, q, vb, qd, tau, gravity=-9.81):
    """Floating-base ABA (JAX ``_fb_aba_body``, :1344): → (v̇b (6,B), q̈
    (n,B)) without the (6+n)² mass matrix — the base closes with one 6×6
    Cholesky."""
    n = ffm.n
    parents = ffm.arm.topology.parents
    inertia, I_base, S = _arm_consts(ffm, q.shape[-1])
    X = blops.joint_transforms_bl(ffm.arm, q)
    R = _quat_rot_s(quat)
    a0_lin = _a0_lin(R, gravity)

    v = [None] * n
    zeta = [None] * n
    for i in range(n):
        p = parents[i]
        Sqd = S[i] * qd[i:i + 1]
        v[i] = blops.matvec6(X[i], vb if p < 0 else v[p]) + Sqd
        zeta[i] = blops.crm_apply_bl(v[i], Sqd)
    IA = list(inertia)
    pA = [blops.crf_apply_bl(v[i], blops.matvec6(inertia[i], v[i]))
          for i in range(n)]
    IA_b = I_base
    pA_b = blops.crf_apply_bl(vb, blops.matvec6(I_base, vb))

    U = [None] * n
    Dinv = [None] * n
    ubar = [None] * n
    for i in range(n - 1, -1, -1):
        Si = S[i]
        Ui = sum(IA[i][:, c] * Si[c:c + 1] for c in range(6))
        # + armature: the reflected rotor inertia in the joint's D
        Di = 1.0 / (sum(Si[c:c + 1] * Ui[c:c + 1] for c in range(6))
                    + ffm.arm.armature[i])
        SpA = sum(Si[c:c + 1] * pA[i][c:c + 1] for c in range(6))
        ui = tau[i:i + 1] - ffm.arm.damping[i] * qd[i:i + 1] - SpA
        U[i], Dinv[i], ubar[i] = Ui, Di, ui
        UDi = Ui * Di
        Ia = IA[i] - UDi[:, None] * Ui[None]
        pa = pA[i] + blops.matvec6(Ia, zeta[i]) + UDi * ui
        IaX = sum(Ia[:, c][:, None] * X[i][c][None] for c in range(6))
        XIaX = sum(X[i][c][:, None] * IaX[c][None] for c in range(6))
        p = parents[i]
        if p >= 0:
            IA[p] = IA[p] + XIaX
            pA[p] = pA[p] + blops.matvec6_T(X[i], pa)
        else:
            IA_b = IA_b + XIaX
            pA_b = pA_b + blops.matvec6_T(X[i], pa)

    # the base: ā_b = −(Iᴬ_b)⁻¹·pᴬ_b by a 6×6 entry-view Cholesky
    E = [[IA_b[r, c:c + 1] for c in range(6)] for r in range(6)]
    ab = torch.cat(_chol_apply_e(_chol_factor_ev(E, 6),
                                 [-pA_b[c:c + 1] for c in range(6)]))
    a = [None] * n
    qdd = [None] * n
    for i in range(n):
        p = parents[i]
        a_prime = blops.matvec6(X[i], ab if p < 0 else a[p]) + zeta[i]
        Ua = sum(U[i][c:c + 1] * a_prime[c:c + 1] for c in range(6))
        qdd[i] = Dinv[i] * (ubar[i] - Ua)
        a[i] = a_prime + S[i] * qdd[i]
    # v̇b = ā_b − a₀' with a₀' = [0₃; a0_lin]
    return torch.cat([ab[:3], ab[3:] - a0_lin]), torch.cat(qdd)


def _vfull_list(ffm, vb, qd):
    """[vb; q̇] as 6+n (1,B) entries."""
    return ([vb[c:c + 1] for c in range(6)]
            + [qd[i:i + 1] for i in range(ffm.n)])


def _contract(JT, x):
    """Σ_c JT[c]·x[c] over the live columns → (3k,B)."""
    return _sum_terms([JT[c] * x[c] for c in range(len(JT))
                       if JT[c] is not None])


def _contact_vel(ffm, quat, q, vfull, links, offsets):
    """The contact points' velocity J(quat, q)·vfull (3k,B), from the
    transforms of the links' support only."""
    X = blops.joint_transforms_bl(ffm.arm, q,
                                  joints=_support(ffm.arm.topology, links))
    J, _ = _ff_contact_rows_s(ffm, X, _quat_rot_s(quat), links, offsets)
    return _contract(_jt_stacks(J, 6 + ffm.n, q[0:1]), vfull)


def _contact_bias(ffm, quat, q, vb, qd, links, offsets):
    """J̇·[vb; q̇] (3k,B): the exact derivative of the contact velocity
    J(quat, q)·[vb; q̇] along the state's flow (quaṫ = ½ quat ⊗ [0, ω_b],
    q̇), by forward mode."""
    vfull = _vfull_list(ffm, vb, qd)
    w_b = torch.cat([torch.zeros_like(vb[0:1]), vb[:3]])
    dquat = 0.5 * _quat_mul_s(quat, w_b)
    return jvp(lambda quat_, q_: _contact_vel(ffm, quat_, q_, vfull, links,
                                              offsets),
               (quat, q), (dquat, qd))[1]


def _baumgarte(JT, vfull, R, pos, xs, anchors, baumgarte):
    """a* = −2α·J·[vb; q̇] − β²·(x_w − anchor) (3k,B), or None when both
    terms vanish: the β term needs explicit anchors (``anchors=None`` pins
    each point where it is, so its drift is zero)."""
    alpha, beta = (float(b) for b in baumgarte)
    a_star = None
    if alpha != 0.0:
        a_star = -2.0 * alpha * _contract(JT, vfull)
    if beta != 0.0 and anchors is not None:
        drifts = []
        for ci in range(len(xs)):
            x_w = pos + _mv3s(R, xs[ci])
            drifts.extend(x_w[d:d + 1] - float(anchors[ci][d])
                          for d in range(3))
        a_star = _sum_terms([a_star, -beta * beta * torch.cat(drifts)])
    return a_star


def stance_fd_plain(ffm, quat, pos, q, vb, qd, tau, links, offsets,
                    anchors=None, gravity=-9.81, baumgarte=(0.0, 0.0),
                    reg=0.0):
    """Stance FD (JAX ``_stance_body``, :891): → (v̇b (6,B), q̈ (n,B), λ
    (3k,B)). One multi-rhs solve gives M⁻¹Jᵀ and the free accelerations,
    then the Delassus G = J·M⁻¹Jᵀ (+ reg), λ = −G⁻¹(J·y_free + J̇v − a*)
    and y = y_free + M⁻¹Jᵀ·λ."""
    links, reg = tuple(links), float(reg)
    m = 6 + ffm.n
    k3 = 3 * len(links)
    X = blops.joint_transforms_bl(ffm.arm, q)
    R = _quat_rot_s(quat)
    f_b, c_j = _fb_bias_s(ffm, X, R, vb, qd, gravity)
    Lm = _chol_factor_ev(_fb_mass_s(ffm, X), m)
    rhs_free = _rhs_free(f_b, c_j, tau)
    J, xs = _ff_contact_rows_s(ffm, X, R, links, offsets)
    vfull = _vfull_list(ffm, vb, qd)
    JT = _jt_stacks(J, m, q[0:1])

    # one merged solve: rows 0..3k−1 M⁻¹Jᵀ, row 3k y_free
    zero3k = torch.zeros((k3, q.shape[-1]), dtype=q.dtype, device=q.device)
    sol = _chol_apply_e(Lm, [torch.cat([zero3k if JT[c] is None else JT[c],
                                        rhs_free[c]]) for c in range(m)])
    MiJt = [sol[c][:k3] for c in range(m)]
    y_free = [sol[c][k3:] for c in range(m)]

    bias = _contact_bias(ffm, quat, q, vb, qd, links, offsets)
    a_star = _baumgarte(JT, vfull, R, pos, xs, anchors, baumgarte)
    # G's lower triangle (the factor reads no other entry)
    G_rows = [_sum_terms([J[r][c] * MiJt[c][:r + 1] for c in range(m)
                          if J[r][c] is not None]) for r in range(k3)]
    Jyf = _contract(JT, y_free)
    rhs = -(Jyf + bias - (0.0 if a_star is None else a_star))
    G = [[G_rows[r][s:s + 1] if s <= r else None for s in range(k3)]
         for r in range(k3)]
    lam = _chol_solve_act(_chol_factor_act(G, k3, reg=reg), rhs[:, None])[:, 0]
    y = [y_free[c] + sum(MiJt[c][s:s + 1] * lam[s:s + 1] for s in range(k3))
         for c in range(m)]
    return torch.cat(y[:6]), torch.cat(y[6:]), lam


# --------------------------------------------------------------------------
# the frictional ground step
# --------------------------------------------------------------------------
def _quat_exp_s(w_dt):
    """(3,B) body rotation vectors → (4,B) unit quaternions exp(½·)."""
    half = 0.5 * w_dt
    ang = torch.sqrt(half[0:1] * half[0:1] + half[1:2] * half[1:2]
                     + half[2:3] * half[2:3] + 1e-30)
    s = torch.sin(ang) / ang
    return torch.cat([torch.cos(ang), s * half[0:1], s * half[1:2],
                      s * half[2:3]])


def _pgs_rows(G, b, mu, active, k, iters, regs, eq=0):
    """Projected Gauss–Seidel on the Delassus rows (JAX ``_pgs_rows``,
    :1128): G an entry view (``G[r][j]`` (1,B), both triangles), b 3k + eq
    (1,B) entries, mu (k,B), active k (1,B) 0/1 masks, ``regs`` the per-row
    ridge (3k + eq floats), applied algebraically — (G + reg·I)·p = G·p +
    reg·p — and in the clipped diagonal. Each sweep visits the contacts in
    order; a contact's three candidates use the impulses before its own
    update, its normal one is clipped at 0 (and to 0 where inactive), its
    tangential pair scaled into the cone ‖pt‖ ≤ μ·pn; then each of the
    ``eq`` trailing bilateral rows (loop closures) takes its Gauss–Seidel
    update unprojected. → impulses (3k + eq,B)."""
    rows = 3 * k + eq

    def residual(r):
        return (_sum_terms([G[r][j] * p[j] for j in range(rows)])
                + regs[r] * p[r]) + b[r]

    diag = [torch.clamp(G[d][d] + regs[d], min=1e-9) for d in range(rows)]
    p = [torch.zeros_like(b[0]) for _ in range(rows)]
    for _ in range(iters):
        for i in range(k):
            s = 3 * i
            cand = [p[s + d] - residual(s + d) / diag[s + d]
                    for d in range(3)]
            pn = torch.clamp(cand[2], min=0.0) * active[i]
            norm_t = torch.sqrt(cand[0] * cand[0] + cand[1] * cand[1] + 1e-30)
            scale = torch.clamp(mu[i:i + 1] * pn / norm_t, max=1.0)
            p[s:s + 3] = [cand[0] * scale, cand[1] * scale, pn]
        for r in range(3 * k, rows):
            p[r] = p[r] - residual(r) / diag[r]
    return torch.cat(p)


def _rotate_rows(C, rows):
    """A contact's three world rows rotated into its frame C = [t1; t2;
    n]: row r is Σ_w C[r][w]·rows[w]."""
    return [[_sum_terms([C[r][w] * rows[w][c] for w in range(3)
                         if rows[w][c] is not None])
             for c in range(len(rows[0]))] for r in range(3)]


def _ground_rows(R, pos, J, xs, ground_z, margin, terrain):
    """Each foot's gap and active mask (k (1,B) each). On the flat ground
    the gap is the world height above ``ground_z``; on a heightfield it is
    measured along the surface normal, and the foot's three world rows of
    J are rotated in place into its contact frame [t1; t2; n] (JAX
    ``_step_ground_body``, :1011-1031)."""
    gaps, active = [], []
    for ci in range(len(xs)):
        p_w = pos + _mv3s(R, xs[ci])
        if terrain is None:
            gap = p_w[2:3] - ground_z
        else:
            h, nrm = _terrain.terrain_surface(terrain, p_w[0:1], p_w[1:2])
            J[3 * ci:3 * ci + 3] = _rotate_rows(_terrain.contact_frame(nrm),
                                                J[3 * ci:3 * ci + 3])
            gap = (p_w[2:3] - h) * nrm[2]
        gaps.append(gap)
        active.append((gap < margin).to(pos.dtype))
    return gaps, active


def ground_geoms_static(geoms):
    """The static ground-contact list of a :class:`..collision.Geoms` set
    (JAX ``ground_geoms_static``, :783; ``()`` for None): the one
    :func:`..collision.make_geoms` keeps on the set, or for a set built
    otherwise :func:`..collision.ground_contacts` of its tensors."""
    if geoms is None:
        return ()
    if geoms.ground is not None:
        return geoms.ground
    from ..collision import ground_contacts

    return ground_contacts(geoms)


def geom_links(static):
    """The links of a static ground-contact list, one a contact."""
    return tuple(l for l, _, _ in static)


def _ground_geom_rows(ffm, R, pos, Rs, ps, contacts, ground_z, margin,
                      terrain):
    """The ground-geom contacts' rows, gaps and active masks (JAX
    ``_ground_geom_rows_s``, :800): for each endpoint sphere (link l, centre
    e, radius r) of ``contacts`` (:func:`ground_geoms_static`), the centre
    in base coordinates e_b (e itself on the base, l = −1), its world
    height and the gap along the surface normal less r, and the rows of
    the material point e_b − r·Rᵀn (on the plane Rᵀe_z is R's third row);
    on a heightfield the rows rotate into the contact frame as the feet's.
    → (3c row lists, c gaps, c masks)."""
    rows, gaps, active = [], [], []
    one = pos[0:1] * 0.0 + 1.0
    for l, e0, r in contacts:
        x_b = (torch.cat([one * c for c in e0]) if l < 0
               else ps[l] + _mv3s_c(Rs[l], e0))
        p_w = pos + _mv3s(R, x_b)
        if terrain is None:
            gap = p_w[2:3] - r - ground_z
            n_b = torch.cat([R[2, j:j + 1] for j in range(3)])
        else:
            h, nrm = _terrain.terrain_surface(terrain, p_w[0:1], p_w[1:2])
            gap = (p_w[2:3] - h) * nrm[2] - r
            n_b = torch.cat([sum(R[d, j:j + 1] * nrm[d] for d in range(3))
                             for j in range(3)])
        g_rows = _point_rows(ffm, R, Rs, ps, l, x_b - r * n_b)
        if terrain is not None:
            g_rows = _rotate_rows(_terrain.contact_frame(nrm), g_rows)
        rows.extend(g_rows)
        gaps.append(gap)
        active.append((gap < margin).to(pos.dtype))
    return rows, gaps, active


def _softness_rows(softness, k, dtype=torch.float64):
    """(3k,) per-row Delassus compliance from a scalar or per-contact (k,)
    ``softness`` (JAX contact.py:993): each cone triplet shares its
    contact's value, the tangent rows softening with the normal."""
    s = torch.broadcast_to(torch.as_tensor(softness, dtype=dtype), (k,))
    return s.repeat_interleave(3)


def _ridge(softness, k):
    """The Delassus ridge of each cone row, 3k floats: 1e-9, plus the
    contact's compliance where ``softness`` is given (the JAX kernel's
    ``eye_reg``, summed in float64)."""
    if softness is None:
        return (1e-9,) * (3 * k)
    return tuple(1e-9 + s for s in _softness_rows(softness, k).tolist())


# the build key's link of an obstacle pair's second side
OBSTACLE = -2


class CollisionStatic(NamedTuple):
    """A collision set as the steppers read it (JAX ``collision_static``,
    :555): ``geoms`` (link, a, b − a, r) a geom and ``obstacles`` (a, b −
    a, r) an obstacle, floats (b − a in float64, as there), and the
    candidate ``pairs`` (geom, geom) and ``obs_pairs`` (geom, obstacle)."""
    geoms: tuple
    obstacles: tuple
    pairs: tuple
    obs_pairs: tuple


def collision_static(cm):
    """The :class:`CollisionStatic` of a :class:`..collision.
    CollisionModel` (the one :func:`..collision.make_collision_model` keeps
    on the set, or made from its tensors), or None for no contacts."""
    if cm is None or not cm.n_contacts:
        return None
    if cm.static is not None:
        return cm.static
    g = cm.geoms
    a, b, r = (_col._numpy(x).astype(np.float64) for x in (g.a, g.b, g.r))
    geoms = tuple((int(l), tuple(a[i].tolist()), tuple((b[i] - a[i]).tolist()),
                   float(r[i])) for i, l in enumerate(g.links))
    obstacles = ()
    if cm.obstacles is not None:
        oa, ob, orr = (_col._numpy(x).astype(np.float64)
                       for x in (cm.obstacles.a, cm.obstacles.b,
                                 cm.obstacles.r))
        obstacles = tuple((tuple(oa[w].tolist()), tuple((ob[w] - oa[w])
                                                        .tolist()),
                           float(orr[w])) for w in range(oa.shape[0]))
    return CollisionStatic(geoms, obstacles,
                           tuple((int(i), int(j)) for i, j in cm.pairs),
                           tuple((int(i), int(w)) for i, w in cm.obs_pairs))


def collision_links(cs):
    """What the rows' columns depend on, a contact: (link of geom A, link
    of geom B) for a self pair, (link of the geom, :data:`OBSTACLE`) for
    an obstacle pair (−1: the base) — the build key's part."""
    if cs is None:
        return ()
    return (tuple((cs.geoms[i][0], cs.geoms[j][0]) for i, j in cs.pairs)
            + tuple((cs.geoms[i][0], OBSTACLE) for i, _ in cs.obs_pairs))


def collision_values(cs):
    """The kernel's run-time geometry, 14 floats a contact: side A's start,
    vector and radius, then side B's (the second geom in its link's frame,
    or the obstacle in the world's)."""
    if cs is None:
        return ()
    sides = ([(cs.geoms[i], cs.geoms[j]) for i, j in cs.pairs]
             + [(cs.geoms[i], (None,) + cs.obstacles[w])
                for i, w in cs.obs_pairs])
    return tuple(v for A, B in sides
                 for v in (*A[1], *A[2], A[3], *B[1], *B[2], B[3]))


def _collision_rows_s(ffm, X, R, pos, cs, fk=None):
    """The collision contacts' rows (JAX ``_collision_rows_s``, :577):
    (3c row lists over the 6+n columns, c gaps (1,B)), the self pairs, then
    the obstacle pairs. Each contact's rows are its frame (t1, t2, n) —
    n = R·n_b from B to A — dotted with the world columns of its point: a
    self pair only the arm columns' difference (its base columns cancel),
    an obstacle pair — the obstacle brought into base coordinates as
    Rᵀ(a_w − pos), Rᵀd_w — the full base block. ``fk`` = (Rs, ps) of
    :func:`_fk_s` where the caller has them."""
    m = 6 + ffm.n
    Rs, ps = fk or _fk_s(ffm.arm, X, _support(
        ffm.arm.topology, [l for l, *_ in cs.geoms if l >= 0]))
    segs = _col._geom_segments_bl(cs, Rs, ps, pos)
    rows, gaps = [], []

    def emit(gap, nrm_b, base_cols, arm):
        frame = _col._contact_frame_cols_bl(_mv3s(R, nrm_b))
        wcols = {j: _mv3s(R, c) for j, c in arm.items()}
        gaps.append(gap)
        for r in range(3):
            row = [None] * m
            if base_cols is not None:
                for j in range(3):
                    row[j] = _col._dot(frame[r], base_cols[j])
                for j in range(3):
                    row[3 + j] = _col._dot(frame[r], R[:, j])
            for j, c in wcols.items():
                row[6 + j] = _col._dot(frame[r], c)
            rows.append(row)

    for gi, gj in cs.pairs:
        gap, nrm_b, pt_b = _col._pair_geometry_bl(
            *segs[gi], cs.geoms[gi][3], *segs[gj], cs.geoms[gj][3])
        ci = _col._arm_point_jac_bl(ffm, Rs, ps, cs.geoms[gi][0], pt_b)
        cj = _col._arm_point_jac_bl(ffm, Rs, ps, cs.geoms[gj][0], pt_b)
        emit(gap, nrm_b, None,
             {j: (ci[j] - cj[j] if j in cj else ci[j]) if j in ci else -cj[j]
              for j in sorted(set(ci) | set(cj))})
    for gi, w in cs.obs_pairs:
        aw, dw, rw = cs.obstacles[w]
        a_b = _mv3s(R, torch.cat([aw[d] - pos[d:d + 1] for d in range(3)]),
                    tA=True)
        gap, nrm_b, pt_b = _col._pair_geometry_bl(
            *segs[gi], cs.geoms[gi][3], a_b, _mtv3s_c(R, dw), rw)
        emit(gap, nrm_b, _omega_cols(R, pt_b),
             _col._arm_point_jac_bl(ffm, Rs, ps, cs.geoms[gi][0], pt_b))
    return rows, gaps


class LoopStatic(NamedTuple):
    """A ``loops=(pairs, offsets_a, offsets_b)`` set as the steppers read it
    (JAX ``loops_static``, :657): the (a, b) link pairs (b = −1: a world
    pin) and each pair's two offsets (3 floats each; b's is the world
    anchor of a pin)."""
    pairs: tuple
    offsets: tuple


def loops_static(n, loops):
    """The :class:`LoopStatic` of a loop set, checked as the JAX package
    checks it (:func:`..loops._check_fb_pairs`); None for None."""
    if loops is None:
        return None
    from ..loops import _check_fb_pairs

    lpairs, loa, lob = loops
    lpairs = _check_fb_pairs(n, lpairs, loa, lob)
    oa, ob = (_col._numpy(x).astype(np.float64) for x in (loa, lob))
    return LoopStatic(tuple((int(a), int(b)) for a, b in lpairs),
                      tuple((tuple(oa[i].tolist()), tuple(ob[i].tolist()))
                            for i in range(len(lpairs))))


def loop_values(ls):
    """The kernel's run-time loop geometry, 6 floats a pair: the offset on
    link a, then b's offset (or a pin's anchor)."""
    return () if ls is None else tuple(v for oa, ob in ls.offsets
                                       for v in (*oa, *ob))


def _loop_rows_s(ffm, X, R, pos, ls, fk=None):
    """The loop closures' bilateral rows (JAX ``_loop_rows_s``, :671):
    (3L row lists, 3L world-frame gap components (1,B), the points x_a and
    x_b in base coordinates, x_b None for a pin). A link↔link pair carries
    no base linear columns (both points ride the base), its angular ones
    R·(e_j × (x_a − x_b)) and the arm columns' difference; a world pin
    (b = −1) measures against its anchor and carries the full base
    block."""
    m = 6 + ffm.n
    Rs, ps = fk or _fk_s(ffm.arm, X, _support(
        ffm.arm.topology, [l for pr in ls.pairs for l in pr if l >= 0]))

    def side(link, off):
        x = ps[link] + _mv3s_c(Rs[link], off)
        return x, _col._arm_point_jac_bl(ffm, Rs, ps, link, x)

    rows, gaps, xas, xbs = [], [], [], []
    for (a, b), (oa, ob) in zip(ls.pairs, ls.offsets):
        xa, ca = side(a, oa)
        xb = None
        if b >= 0:
            xb, cb = side(b, ob)
            rel = xa - xb
            arm = {j: (ca[j] - cb[j] if j in cb else ca[j]) if j in ca
                   else -cb[j] for j in sorted(set(ca) | set(cb))}
            gap = _mv3s(R, rel)
        else:
            rel, arm = xa, ca
            gw = _mv3s(R, xa)
            gap = torch.cat([pos[d:d + 1] + gw[d:d + 1] - ob[d]
                             for d in range(3)])
        wcols = _omega_cols(R, rel)
        armw = {j: _mv3s(R, c) for j, c in arm.items()}
        for r in range(3):
            row = [None] * m
            for j in range(3):
                row[j] = wcols[j][r:r + 1]
            if b < 0:
                for j in range(3):
                    row[3 + j] = R[r, j:j + 1]
            for j, c in armw.items():
                row[6 + j] = c[r:r + 1]
            rows.append(row)
            gaps.append(gap[r:r + 1])
        xas.append(xa)
        xbs.append(xb)
    return rows, gaps, xas, xbs


def _rows_support(ffm, links, ground_static, cs, ls):
    """The joints every row of a step reads (:func:`_support` of all the
    links its contacts and closures ride)."""
    extra = [g[0] for g in ground_static]
    if cs is not None:
        extra += [g[0] for g in cs.geoms]
    if ls is not None:
        extra += [l for pr in ls.pairs for l in pr]
    return _support(ffm.arm.topology,
                    tuple(links) + tuple(l for l in extra if l >= 0))


def step_ground_plain(ffm, quat, pos, q, vb, qd, tau, mu, dt, links, offsets,
                      ground_z=0.0, gravity=-9.81, iters=30, erp=0.2,
                      margin=1e-3, restitution=0.0, push=None, softness=None,
                      terrain=None, ground_static=(), collision_static=None,
                      loop_static=None):
    """One frictional ground step (JAX ``_step_ground_body``, :977): the
    free velocity v_free = v + dt·M⁻¹[push − f_b; τ − c_j]; the rows J in
    the JAX order — the k feet (rotated into each contact's frame on a
    ``terrain``), the collision contacts ``collision_static``
    (:func:`collision_static`, :func:`_collision_rows_s`), the geoms'
    endpoint spheres ``ground_static`` (:func:`ground_geoms_static`), then
    the loop closures' bilateral rows ``loop_static`` (:func:`loops_static`,
    :func:`_loop_rows_s`) — and the gaps; the Delassus G = J·M⁻¹Jᵀ (its
    lower triangle, read both ways) and b = J·v_free, less v* =
    −erp·min(gap, 0)/dt − restitution·min(vn, 0) on the cone normals and
    plus erp·gap/dt on the loop rows; ``iters`` PGS sweeps for the impulses
    p; v⁺ = v_free + M⁻¹Jᵀ·p, the attitude quat ⊗ exp(½·ω⁺·dt)
    renormalised, pos by the new rotation and q by q̇⁺. → (quat⁺ (4,B),
    pos⁺ (3,B), q⁺ (n,B), vb⁺ (6,B), q̇⁺ (n,B), the cone impulses p
    (3k_t,B)). ``mu`` (k_t,B), the feet's rows, the collision contacts',
    then the geoms'; ``softness`` a scalar or (k_t,) (the loop rows keep
    the bare 1e-9 ridge); ``push`` (6,B) or None."""
    links = tuple(int(l) for l in links)
    ground_static = tuple(ground_static)
    m = 6 + ffm.n
    X = blops.joint_transforms_bl(ffm.arm, q)
    R = _quat_rot_s(quat)
    f_b, c_j = _fb_bias_s(ffm, X, R, vb, qd, gravity)
    Lm = _chol_factor_ev(_fb_mass_s(ffm, X), m)
    rhs_free = _rhs_free(f_b, c_j, tau, push)
    v = _vfull_list(ffm, vb, qd)
    fk = _fk_s(ffm.arm, X, _rows_support(ffm, links, ground_static,
                                         collision_static, loop_static))
    J, xs = _ff_contact_rows_s(ffm, X, R, links, offsets, fk)
    if terrain is not None:
        terrain = _terrain.placed(terrain, q.device, q.dtype)[0]
    gaps, active = _ground_rows(R, pos, J, xs, ground_z, margin, terrain)
    if collision_static is not None:
        c_rows, c_gaps = _collision_rows_s(ffm, X, R, pos, collision_static,
                                           fk)
        J, gaps = J + c_rows, gaps + c_gaps
        active = active + [(g < margin).to(pos.dtype) for g in c_gaps]
    if ground_static:
        g_rows, g_gaps, g_active = _ground_geom_rows(
            ffm, R, pos, *fk, ground_static, ground_z, margin, terrain)
        J, gaps, active = J + g_rows, gaps + g_gaps, active + g_active
    kt = len(gaps)
    l_gaps = []
    if loop_static is not None:
        l_rows, l_gaps, _, _ = _loop_rows_s(ffm, X, R, pos, loop_static, fk)
        J = J + l_rows
    k3 = 3 * kt
    rows_t = len(J)
    JT = _jt_stacks(J, m, q[0:1])

    # one merged solve: rows 0..R−1 M⁻¹Jᵀ, row R the free acceleration
    zeroR = torch.zeros((rows_t, q.shape[-1]), dtype=q.dtype, device=q.device)
    sol = _chol_apply_e(Lm, [torch.cat([zeroR if JT[c] is None else JT[c],
                                        rhs_free[c]]) for c in range(m)])
    MiJt = [sol[c][:rows_t] for c in range(m)]
    v_free = [v[c] + dt * sol[c][rows_t:] for c in range(m)]

    def row_dot(r, x):
        return _sum_terms([J[r][c] * x[c] for c in range(m)
                           if J[r][c] is not None])
    G_low = [_sum_terms([J[r][c] * MiJt[c][:r + 1] for c in range(m)
                         if J[r][c] is not None]) for r in range(rows_t)]
    G = [[G_low[max(r, s)][min(r, s):min(r, s) + 1] for s in range(rows_t)]
         for r in range(rows_t)]
    b = [row_dot(r, v_free) for r in range(rows_t)]
    for ci, gap in enumerate(gaps):
        v_star = -erp * torch.clamp(gap, max=0.0) / dt
        if restitution:
            vn_now = row_dot(3 * ci + 2, v)
            v_star = v_star - restitution * torch.clamp(vn_now, max=0.0)
        b[3 * ci + 2] = b[3 * ci + 2] - v_star
    for j, gap in enumerate(l_gaps):           # the loops' gap recovery
        b[k3 + j] = b[k3 + j] + erp * gap / dt
    p = _pgs_rows(G, b, mu, active, kt, int(iters),
                  _ridge(softness, kt) + (1e-9,) * (rows_t - k3),
                  eq=rows_t - k3)

    v_new = torch.cat([v_free[c] + _sum_terms([MiJt[c][s:s + 1] * p[s:s + 1]
                                               for s in range(rows_t)])
                       for c in range(m)])
    vb2, qd2 = v_new[:6], v_new[6:]
    quat2 = _quat_mul_s(quat, _quat_exp_s(vb2[:3] * dt))
    quat2 = quat2 / torch.sqrt(quat2[0:1] * quat2[0:1] + quat2[1:2] * quat2[1:2]
                               + quat2[2:3] * quat2[2:3]
                               + quat2[3:4] * quat2[3:4])
    pos2 = pos + dt * _mv3s(_quat_rot_s(quat2), vb2[3:])
    q2 = q + dt * qd2
    return quat2, pos2, q2, vb2, qd2, p[:k3]


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _geom_copy(values, dtype, device, width=3):
    return torch.tensor(values, dtype=dtype, device=device).reshape(-1, width)


def device_geoms(static, dtype, device):
    """A static ground-contact list's spheres as one device array (c, 4) —
    each centre, then its radius — in ``dtype`` on ``device``, copied once
    a set of values and kept; None for no geoms."""
    if not static:
        return None
    return _geom_copy(tuple(v for _, e, r in static for v in (*e, r)),
                      dtype, torch.device(device), 4)


def _device_geom(ffm, x, k):
    """Foot offsets or anchors (k, 3) on the model's device, copied once a
    set of values and kept, so a loop of calls on one stance makes no
    host-to-device copy."""
    if x is None:
        return None
    values = tuple(torch.as_tensor(x, dtype=torch.float64).reshape(-1)
                   .tolist())
    if len(values) != 3 * k:
        raise ValueError(f"expected ({k}, 3) contact points, got "
                         f"{len(values)} values")
    return _geom_copy(values, ffm.dtype, torch.device(ffm.device))


def _ff_states(ffm, quat, q, vb, qd, tau, pos=None):
    n = ffm.n
    return [(quat, 4, "quat"), (q, n, "n"), (vb, 6, "vb"), (qd, n, "n"),
            (tau, n, "n")] + ([] if pos is None else [(pos, 3, "pos")])


def fb_aba_fused(ffm, quat, q, vb, qd, tau, gravity=-9.81):
    """Floating-base ABA: → (v̇b (6,B), q̈ (n,B)), O(n) a state."""
    if on_cpu(q):
        return fb_aba_plain(ffm, quat, q, vb, qd, tau, gravity)
    B = check_ff(ffm, _ff_states(ffm, quat, q, vb, qd, tau))
    dvb, qdd = empty(ffm, 6, B), empty(ffm, ffm.n, B)
    if B:
        launch("fb_aba", "grid_fb_aba", ffm,
               (quat.data_ptr(), q.data_ptr(), vb.data_ptr(), qd.data_ptr(),
                tau.data_ptr(), dvb.data_ptr(), qdd.data_ptr()), B,
               float(gravity))
    return dvb, qdd


def fb_fd_fused(ffm, quat, q, vb, qd, tau, gravity=-9.81):
    """Free-flyer FD by the (6+n)² mass matrix and its Cholesky factor: →
    (v̇b (6,B), q̈ (n,B))."""
    if on_cpu(q):
        return fb_fd_plain(ffm, quat, q, vb, qd, tau, gravity)
    B = check_ff(ffm, _ff_states(ffm, quat, q, vb, qd, tau))
    dvb, qdd = empty(ffm, 6, B), empty(ffm, ffm.n, B)
    if B:
        launch("fb_fd", "grid_fb_fd", ffm,
               (quat.data_ptr(), q.data_ptr(), vb.data_ptr(), qd.data_ptr(),
                tau.data_ptr(), dvb.data_ptr(), qdd.data_ptr()), B,
               float(gravity))
    return dvb, qdd


def stance_fd_fused(ffm, quat, pos, q, vb, qd, tau, links, offsets,
                    anchors=None, gravity=-9.81, baumgarte=(0.0, 0.0),
                    reg=0.0):
    """Stance-constrained FD with the k points of ``links`` (body-frame
    ``offsets`` (k, 3)) pinned to ``anchors`` (k, 3; None: where they are):
    → (v̇b (6,B), q̈ (n,B), λ (3k,B)). The kernel is built per set of links;
    offsets, anchors, gravity, ``baumgarte`` = (α, β) and ``reg`` are
    run-time arguments."""
    links = tuple(int(l) for l in links)
    if on_cpu(q):
        return stance_fd_plain(ffm, quat, pos, q, vb, qd, tau, links,
                               offsets, anchors, gravity, baumgarte, reg)
    B = check_ff(ffm, _ff_states(ffm, quat, q, vb, qd, tau, pos))
    geom = [_device_geom(ffm, x, len(links)) for x in (offsets, anchors)]
    dvb, qdd = empty(ffm, 6, B), empty(ffm, ffm.n, B)
    lam = empty(ffm, 3 * len(links), B)
    if B:
        launch("stance_fd", "grid_stance_fd", ffm,
               (quat.data_ptr(), pos.data_ptr(), q.data_ptr(), vb.data_ptr(),
                qd.data_ptr(), tau.data_ptr(), ptr(geom[0]), ptr(geom[1]),
                dvb.data_ptr(), qdd.data_ptr(), lam.data_ptr()), B,
               float(gravity), float(baumgarte[0]), float(baumgarte[1]),
               float(reg), links=links)
    return dvb, qdd, lam


def _step_launch(ffm, name, entry, quat, pos, q, vb, qd, tau, mu, push,
                 links, offsets, static, cs, ls, softness, extra_ptrs,
                 scalars):
    """Check a ground step's inputs, allocate its outputs (quat⁺ (4,B),
    pos⁺ (3,B), q⁺ (n,B), vb⁺ (6,B), q̇⁺ (n,B), p (3k_t,B)) and launch
    ``entry`` of the library of the k feet, the ground-geom contacts
    ``static`` (their links after the feet's), the collision contacts
    ``cs`` and the loop closures ``ls`` (their links: :func:`collision_links`
    and the pairs). The offsets, the geom spheres, the collision and loop
    geometry and the per-row ridge are device copies kept a set of values
    (:func:`_device_geom`, :func:`device_geoms`)."""
    n, k = ffm.n, len(links)
    kt = k + len(static) + (0 if cs is None else len(collision_links(cs)))
    n_eq = 0 if ls is None else 3 * len(ls.pairs)
    B = check_ff(ffm, _ff_states(ffm, quat, q, vb, qd, tau, pos)
                 + [(mu, kt, "k_t")] + ([] if push is None
                                        else [(push, 6, "push")]))
    outs = tuple(empty(ffm, d, B) for d in (4, 3, n, 6, n, 3 * kt))
    if B:
        dev = torch.device(ffm.device)
        ridge = _geom_copy(_ridge(softness, kt) + (1e-9,) * n_eq, ffm.dtype,
                           dev)
        extra = [_geom_copy(v, ffm.dtype, dev, 1) if v else None
                 for v in (collision_values(cs), loop_values(ls))]
        launch(name, entry, ffm,
               (quat.data_ptr(), pos.data_ptr(), q.data_ptr(), vb.data_ptr(),
                qd.data_ptr(), tau.data_ptr(), mu.data_ptr(), ptr(push),
                _device_geom(ffm, offsets, k).data_ptr(),
                ptr(device_geoms(static, ffm.dtype, ffm.device)),
                *(ptr(x) for x in extra),
                ridge.data_ptr(), *(o.data_ptr() for o in outs),
                *extra_ptrs), B, k, *scalars,
               links=links + geom_links(static),
               pairs=(collision_links(cs), () if ls is None else ls.pairs))
    return outs


def step_ground_fused(ffm, quat, pos, q, vb, qd, tau, mu, dt, links, offsets,
                      ground_z=0.0, gravity=-9.81, iters=30, erp=0.2,
                      margin=1e-3, restitution=0.0, push=None, softness=None,
                      ground_geoms=None, collision=None, loops=None):
    """One frictional step on the flat ground ``z = ground_z`` for the feet
    ``links`` (body-frame ``offsets`` (k, 3)), the self and obstacle pairs
    of ``collision`` (a :class:`..collision.CollisionModel`), the endpoint
    spheres of ``ground_geoms`` (a :class:`..collision.Geoms`, links −1 …
    n−1) and the loop closures ``loops`` = (pairs, offsets_a, offsets_b):
    batch-last states, ``mu`` (k_t,B) — the feet's rows, the collision
    contacts', then the geoms' —, optional ``push`` (6,B) and ``softness``
    (scalar or (k_t,)) → (quat⁺, pos⁺, q⁺, vb⁺, q̇⁺, impulses (3k_t,B)).
    The kernel is built per set of feet, geom, collision and loop links;
    everything else is a run-time argument."""
    links = tuple(int(l) for l in links)
    static = ground_geoms_static(ground_geoms)
    cs, ls = collision_static(collision), loops_static(ffm.n, loops)
    if on_cpu(q):
        return step_ground_plain(ffm, quat, pos, q, vb, qd, tau, mu, dt,
                                 links, offsets, ground_z, gravity, iters,
                                 erp, margin, restitution, push, softness,
                                 ground_static=static, collision_static=cs,
                                 loop_static=ls)
    return _step_launch(
        ffm, "step_ground", "grid_step_ground", quat, pos, q, vb, qd, tau, mu,
        push, links, offsets, static, cs, ls, softness, (),
        (float(dt), float(ground_z), float(gravity), int(iters), float(erp),
         float(margin), float(restitution)))


def step_ground_terrain_fused(ffm, quat, pos, q, vb, qd, tau, mu, dt, links,
                              offsets, terrain, gravity=-9.81, iters=30,
                              erp=0.2, margin=1e-3, restitution=0.0,
                              push=None, softness=None, ground_geoms=None,
                              collision=None, loops=None):
    """:func:`step_ground_fused` on a bilinear heightfield ``terrain``
    (:class:`..terrain.Terrain`): each ground contact's gap along the
    surface normal and its rows in its contact frame (the collision and
    loop rows do not see the ground). The grid is read from device memory
    (kept on the model's device, in its dtype, once a terrain), so every
    grid size runs the kernel."""
    links = tuple(int(l) for l in links)
    static = ground_geoms_static(ground_geoms)
    cs, ls = collision_static(collision), loops_static(ffm.n, loops)
    if on_cpu(q):
        return step_ground_plain(ffm, quat, pos, q, vb, qd, tau, mu, dt,
                                 links, offsets, 0.0, gravity, iters, erp,
                                 margin, restitution, push, softness, terrain,
                                 ground_static=static, collision_static=cs,
                                 loop_static=ls)
    terr, x0, y0 = _terrain.placed(terrain, ffm.device, ffm.dtype)
    H, W = terr.heights.shape
    return _step_launch(
        ffm, "step_ground_terrain", "grid_step_ground_terrain", quat, pos, q,
        vb, qd, tau, mu, push, links, offsets, static, cs, ls, softness,
        (terr.heights.data_ptr(),),
        (float(dt), float(gravity), int(iters), float(erp), float(margin),
         float(restitution), int(H), int(W), float(terr.cell), x0, y0))
