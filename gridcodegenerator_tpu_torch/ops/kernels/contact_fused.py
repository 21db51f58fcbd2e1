"""Dense factor helpers of the contact kernels, in batch-last PyTorch.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/
contact_fused.py``. So far it holds what the staged large-robot pipeline
(:mod:`.staged`) and the multi-dof bodies (:mod:`..md_blops`) use: the
active-region column Cholesky of an ancestor-sparse mass matrix
(:func:`_chol_factor_act`), the symmetric inverse from it
(:func:`_chol_minv_sym`), the multi-rhs solve (:func:`_chol_solve_act`),
the entry-view factor and its solve (:func:`_act_view`,
:func:`_chol_factor_ev`, :func:`_chol_apply_e`), :func:`_sum_terms` and the
quaternion rotation :func:`_quat_rot_s`. Entries are (1, B) tensors,
``None`` where structurally zero; every sum runs left to right, the order
the CUDA kernels (``csrc/chol.cuh``, ``staged.cuh``, ``md.cuh``) keep.
"""

from __future__ import annotations

import torch


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


def _chol_factor_act(M, m):
    """Left-looking column Cholesky of an m×m list of lists of (1,B)/None
    entries, restricted to the active region: ``cols[j]`` is the (m−j, B)
    stack of rows j..m−1 of L's column j (``cols[j][0:1]`` is the
    diagonal)."""
    zero = next(torch.zeros_like(e) for row in M for e in row
                if e is not None)
    cols = []
    for j in range(m):
        c = torch.cat([zero if M[i][j] is None else M[i][j]
                       for i in range(j, m)])                  # (m-j, B)
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
