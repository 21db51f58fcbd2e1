"""The staged multi-dof pipeline for robots past the single-thread gradient
kernels (free Atlas: n 29, nq 35, nv 34) and its plain stages.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/
multidof_staged.py``, with the same names and batch-last signatures: q
(nq, B), q̇, q̈ and u (nv, B). The single-thread ∂ID and ∇FD kernels
(:mod:`.multidof_fused`) keep the ∂v/∂a/∂f tensors of every joint for all
nv directions (18·n·nv values) on one thread; here the tangent-space ∂ID
is cut into column blocks of ``cb`` directions, so each kernel's per-thread
arrays grow as n·cb, with small per-state tensors staged through device
memory between the kernels and X(q) recomputed in each:

  K2md+q̈  q, q̇, u            → M⁻¹, q̈     bias RNEA, CRBA, active-region
                                            Cholesky, L⁻ᵀL⁻¹, q̈ = M⁻¹(u − c)
  K1md    q, q̇[, q̈]          → v, a, f    the sweep at q̈, (6, n, B) each
  K5md    q, q̇, v, a, f[, M⁻¹] → ∂c or −M⁻¹·∂c, column block by column
          block, both sides, every block in one launch (a 2-D grid)

∇FD is K2md+q̈, K1md and K5md with the fused finish (three launches);
∂q̈/∂u = M⁻¹ comes from K2md. ∂ID is K1md and K5md without it (two).
``md_minv_fused`` is K2md alone. A block may cut a ball or free joint's
directions (with cb = 4 a free root's six go 4 + 2). Each stage wrapper
runs its plain version (``*_plain``, built on :mod:`..md_blops`) on CPU
tensors and its kernel (``csrc/md_staged.cu``) on CUDA tensors, or raises;
there is no fallback between the two.

``cb`` is the K5md column-block width. ``None`` takes the width the kernels
are compiled for (``_build.md_col_block``); a smaller one forces narrower
blocks (the tests use it to cut a joint on a small robot). Blocks are
[c0, c0 + cb) from 0 with a ragged last one — not the JAX module's
equal-ish split (``_split_cols``), a TPU fitting choice like its
``_side_plan`` and ``merge_sides``; every direction's column is computed
alone, so the split changes no value.
"""

from __future__ import annotations

import torch

from .. import md_blops
from . import _build
from ._launch import check_md, check_staged, empty, launch, on_cpu, ptr


def _as_list(stacked, n):
    """(6, n, B) staged tensor → per-joint list of (6, B)."""
    return [stacked[:, i] for i in range(n)]


def _col_block(model, cb):
    full = _build.md_col_block(model.n, model.nv)
    if cb is None:
        return full
    if not 1 <= cb <= full:
        raise ValueError(f"cb must be in [1, {full}] for robot "
                         f"'{model.name}' (n={model.n}, nv={model.nv}), "
                         f"got {cb}")
    return cb


def _blocks(nv, cb):
    return [(c0, min(cb, nv - c0)) for c0 in range(0, nv, cb)]


# --------------------------------------------------------------------------
# plain stages (any device)
# --------------------------------------------------------------------------
def md_vaf_plain(model, q, qd, qdd=None, gravity=-9.81):
    X = md_blops.md_transforms_bl(model, q)
    _, v, a, f = md_blops.md_rnea_bl(model, X, qd, qdd, gravity)
    return (torch.stack(v, dim=1), torch.stack(a, dim=1),
            torch.stack(f, dim=1))


def md_minv_plain(model, q):
    return md_blops.md_minv_bl(model, md_blops.md_transforms_bl(model, q))


def md_minv_qdd_plain(model, q, qd, u, gravity=-9.81):
    return md_blops.md_minv_qdd_bl(model, q, qd, u, gravity)


def md_grad_cols_plain(model, q, qd, v, a, f, gravity=-9.81, cb=None,
                       Minv=None):
    """K5md over every column block: (∂c/∂δq, ∂c/∂q̇), or with ``Minv``
    (nv, nv, B) the fused −M⁻¹·∂c finish, each (nv, nv, B)."""
    cb = _col_block(model, cb)
    X = md_blops.md_transforms_bl(model, q)
    vl, al, fl = (_as_list(t, model.n) for t in (v, a, f))
    blocks = [md_blops.md_id_grad_bl(model, X, qd, vl, al, fl, gravity,
                                     c0=c0, cb=w, minv=Minv)
              for c0, w in _blocks(model.nv, cb)]
    return tuple(torch.cat(sides, dim=1) for sides in zip(*blocks))


def md_id_grad_staged_plain(model, q, qd, qdd=None, gravity=-9.81, cb=None):
    v, a, f = md_vaf_plain(model, q, qd, qdd, gravity)
    return md_grad_cols_plain(model, q, qd, v, a, f, gravity, cb=cb)


def md_fd_grad_staged_plain(model, q, qd, u, gravity=-9.81, cb=None):
    Minv, qdd = md_minv_qdd_plain(model, q, qd, u, gravity)
    v, a, f = md_vaf_plain(model, q, qd, qdd, gravity)
    return (*md_grad_cols_plain(model, q, qd, v, a, f, gravity, cb=cb,
                                Minv=Minv), Minv)


# --------------------------------------------------------------------------
# stage wrappers: the plain stage on CPU tensors, the kernel on CUDA tensors
# --------------------------------------------------------------------------
def md_vaf_staged(model, q, qd, qdd=None, gravity=-9.81):
    """K1md: v, a, f, each (6, n, B), f summed to the root; at q̈ = 0 for
    ``qdd=None``."""
    if on_cpu(q):
        return md_vaf_plain(model, q, qd, qdd, gravity)
    B = check_md(model, q, [qd] if qdd is None else [qd, qdd])
    v, a, f = (empty(model, 6, model.n, B) for _ in range(3))
    if B:
        launch("md_vaf", "grid_md_vaf", model,
               (q.data_ptr(), qd.data_ptr(), ptr(qdd), v.data_ptr(),
                a.data_ptr(), f.data_ptr()), B, float(gravity))
    return v, a, f


def md_minv_fused(model, q):
    """K2md: dense symmetric M⁻¹ (nv, nv, B)."""
    if on_cpu(q):
        return md_minv_plain(model, q)
    B = check_md(model, q, [])
    Minv = empty(model, model.nv, model.nv, B)
    if B:
        launch("md_minv", "grid_md_minv", model,
               (q.data_ptr(), None, None, Minv.data_ptr(), None), B, 0.0)
    return Minv


def md_minv_qdd_fused(model, q, qd, u, gravity=-9.81):
    """K2md with the bias force and q̈: (M⁻¹ (nv, nv, B), q̈ (nv, B))."""
    if on_cpu(q):
        return md_minv_qdd_plain(model, q, qd, u, gravity)
    B = check_md(model, q, [qd, u])
    Minv = empty(model, model.nv, model.nv, B)
    qdd = empty(model, model.nv, B)
    if B:
        launch("md_minv_qdd", "grid_md_minv", model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(), Minv.data_ptr(),
                qdd.data_ptr()), B, float(gravity))
    return Minv, qdd


def md_grad_cols_staged(model, q, qd, v, a, f, gravity=-9.81, cb=None,
                        Minv=None):
    """K5md: every column block of both sides in one launch — (∂c/∂δq,
    ∂c/∂q̇), or with ``Minv`` (nv, nv, B) the fused −M⁻¹·∂c finish."""
    if on_cpu(q):
        return md_grad_cols_plain(model, q, qd, v, a, f, gravity, cb, Minv)
    B = check_md(model, q, [qd])
    n, nv = model.n, model.nv
    for name, t in (("v", v), ("a", a), ("f", f)):
        check_staged(model, name, t, (6, n, B))
    if Minv is not None:
        check_staged(model, "Minv", Minv, (nv, nv, B))
    cb = _col_block(model, cb)
    dq, dqd = empty(model, nv, nv, B), empty(model, nv, nv, B)
    if B:
        launch("md_grad_cols" if Minv is None else "md_grad_cols_finish",
               "grid_md_grad_cols", model,
               (q.data_ptr(), qd.data_ptr(), v.data_ptr(), a.data_ptr(),
                f.data_ptr(), ptr(Minv), dq.data_ptr(), dqd.data_ptr()),
               B, cb, float(gravity))
    return dq, dqd


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------
def md_id_grad_staged(model, q, qd, qdd=None, gravity=-9.81, cb=None):
    """Staged tangent-space ∂ID: (∂τ/∂δq, ∂τ/∂q̇), each (nv, nv, B) — K1md
    and K5md."""
    v, a, f = md_vaf_staged(model, q, qd, qdd, gravity)
    return md_grad_cols_staged(model, q, qd, v, a, f, gravity, cb=cb)


def md_fd_grad_staged(model, q, qd, u, gravity=-9.81, cb=None):
    """Staged tangent-space ∇FD: (∂q̈/∂δq, ∂q̈/∂q̇, ∂q̈/∂u), each
    (nv, nv, B) — K2md+q̈, K1md at q̈, K5md with the fused finish; ∂q̈/∂u is
    K2md's M⁻¹."""
    Minv, qdd = md_minv_qdd_fused(model, q, qd, u, gravity)
    v, a, f = md_vaf_staged(model, q, qd, qdd, gravity)
    return (*md_grad_cols_staged(model, q, qd, v, a, f, gravity, cb=cb,
                                 Minv=Minv), Minv)
