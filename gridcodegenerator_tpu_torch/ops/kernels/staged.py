"""The staged pipeline for large robots (Atlas-scale), its variants and
their plain stages.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/staged.py``
(fixed base). The single-thread ∇FD, ∂ID and M⁻¹ kernels keep O(n²) values
a state; past ``MAX_KERNEL_JOINTS`` joints the work is cut into kernels
whose per-thread arrays grow as n·cb, with small per-state tensors staged
through device memory between them and X(q) recomputed in each:

  K1   q, q̇           → c, v        bias RNEA (v does not depend on q̈)
  K2′  q, u − c        → M⁻¹, q̈     CRBA, active-region Cholesky, L⁻ᵀL⁻¹
  K4   q, q̇, q̈, v     → a, f        the second sweep at the true q̈
  K5   q, q̇, v, a, f[, M⁻¹] → ∂c or −M⁻¹·∂c, both sides

K1, K2′, K4, K5 and ∂ID's vaf sweep are CTA tiles (``csrc/tile.cuh``): a
tile of states a CTA, each state's working set in shared memory, every
column of K5 at once. The one-thread-per-state kernels they replaced (K5
column block by column block, every block in one launch on a 2-D grid)
stay as a timed arm, launched when ``_launch.DESIGN`` is ``"thread"`` and
counted under ``<name>_thread``; the same switch takes :mod:`.fused`'s
recursion ∇FD to its one-thread kernel.

The default route: ∇FD is K1, K2′, K4, K5 with the fused finish (four
launches); ∂ID is the vaf sweep and K5 without it (two); ``direct_minv`` is
K2′ alone. The JAX package's A/B variants, reached through this module as
its benchmarks reach them (no public entry point takes one by default):

  K2   q               → U, D⁻¹      the articulated backward sweep
  K3   q, U, D⁻¹       → M⁻¹ upper   its F and row sweeps, column blocks
                                     of ``GRID_MINV_CB``, one 2-D launch
  K2″  q, q̇, u − c, v  → M⁻¹, a, f   K2′ and K4 in one kernel
  fd_dense             q, q̇, u → q̈  bias RNEA, CRBA, factor, one solve

* ``minv_staged``: K2, K3, then the densify in torch (two launches);
  ``fd_staged``: K1 and ``minv_staged``, then the q̈ matvec in torch
  (three); ``fd_dense_staged``: one launch, M⁻¹ never formed.
* ``fd_grad_staged`` options, JAX's names and defaults:
  ``minv_impl="recursion"`` (K1, K2, K3, K4, K5: five launches);
  ``merge_af=True`` (K1, K2″, K5: three, at every n — K2″ builds at
  every n on the card, so JAX's VMEM gate has no counterpart);
  ``fuse_finish=False`` (K5 without the finish, then −M⁻¹·∂c by
  ``blops.matmatN`` in torch, as JAX leaves it to XLA);
  ``merge_sides=False`` (K5 once per side: one launch each);
  ``stage_dtype=torch.bfloat16`` (v, M⁻¹, then a, f cast to bf16 between
  launches; K4 and K5 read them as bf16 and compute in the model's dtype).
  ``id_grad_staged`` takes ``merge_sides`` and ``stage_dtype`` too.

Each stage wrapper runs its plain version (``*_plain``, built on
:mod:`..blops` and :mod:`.contact_fused`) on CPU tensors and its kernel
(``csrc/staged.cu``) on CUDA tensors, or raises; there is no fallback
between the two.

``cb`` is the K5 column-block width. ``None`` takes the width the kernels
are compiled for (``_build.default_col_block``); a smaller one forces
narrower blocks (the tests use it to put a ragged block on a small robot)
in the plain version and the one-thread kernel. No width changes a result,
and the tile computes every column at once.
``minv_staged``'s ``cb`` is K3's, against ``_build.minv_col_block``.
"""

from __future__ import annotations

import torch

from ...models.robot import RobotModel
from .. import blops
from . import _build
from .contact_fused import (_chol_factor_act, _chol_minv_sym,
                            _chol_solve_act)
from ._launch import (check, check_staged, design, empty, launch, on_cpu,
                      ptr)

_SIDES = ("q", "qd")


def _as_list(stacked, n):
    """(6, n, B) staged tensor → per-joint list of (6, B)."""
    return [stacked[:, i] for i in range(n)]


def _col_block(model: RobotModel, cb, full=None, fuse_finish=None):
    """``cb``, checked against the compiled width ``full`` (None: K5's);
    an explicit ``fuse_finish`` names JAX's error for a block its fused
    finish cannot take."""
    full = _build.default_col_block(model.n) if full is None else full
    if cb is None:
        return full
    if not 1 <= cb <= full:
        head = (f"fuse_finish: no VMEM-valid column block for n={model.n}: "
                if fuse_finish else "")
        raise ValueError(f"{head}cb must be in [1, {full}] for robot "
                         f"'{model.name}' (n={model.n}), got {cb}")
    return cb


def _minv_block(model: RobotModel, cb):
    """K3's column-block width: ``cb``, at most the compiled one."""
    return _col_block(model, cb, _build.minv_col_block(model.n))


def _blocks(n, cb):
    return [(c0, min(cb, n - c0)) for c0 in range(0, n, cb)]


def _side_bits(sides) -> int:
    if not sides or any(s not in _SIDES for s in sides) \
            or list(sides) != sorted(set(sides), key=_SIDES.index):
        raise ValueError(f"sides must be ('q',), ('qd',) or ('q', 'qd'), "
                         f"got {sides!r}")
    return ("q" in sides) | 2 * ("qd" in sides)


def _check_stage_dtype(stage_dtype):
    if stage_dtype not in (None, torch.bfloat16):
        raise ValueError("stage_dtype must be None or torch.bfloat16, got "
                         f"{stage_dtype}")


def to_stage(x):
    """``x`` in bfloat16 as JAX's ``astype(jnp.bfloat16)`` gives it: a
    float64 tensor is rounded to float32, then to bf16, each step to nearest
    even (so a value just past a bf16 halfway point may land on it, then
    round to even); float32 is rounded once."""
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    return x.to(torch.bfloat16)


# --------------------------------------------------------------------------
# plain stages (any device)
# --------------------------------------------------------------------------
def bias_and_v_plain(model: RobotModel, q, qd, gravity=-9.81):
    X = blops.joint_transforms_bl(model, q)
    v, _, f0 = blops.rnea_fwd_bl(model, X, qd, None, gravity)
    c, _ = blops.rnea_bwd_bl(model, X, f0, qd)
    return c, torch.stack(v, dim=1)


def _dense_minv(model: RobotModel, X):
    n = model.n
    return _chol_minv_sym(_chol_factor_act(blops.crba_bl(model, X), n), n)


def minv_qdd_dense_plain(model: RobotModel, q, rhs=None):
    n = model.n
    Minv = _dense_minv(model, blops.joint_transforms_bl(model, q))
    if rhs is None:
        return (Minv,)
    return Minv, sum(Minv[:, j] * rhs[j:j + 1] for j in range(n))


def minv_af_plain(model: RobotModel, q, qd, umc, v, gravity=-9.81):
    """K2″: M⁻¹, and (a, f) of the second sweep at q̈ = M⁻¹·umc."""
    n = model.n
    X = blops.joint_transforms_bl(model, q)
    Minv = _dense_minv(model, X)
    qdd = sum(Minv[:, j] * umc[j:j + 1] for j in range(n))
    _, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity,
                                v_known=_as_list(v.to(q.dtype), n))
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    return Minv, torch.stack(a, dim=1), torch.stack(f, dim=1)


def fd_dense_plain(model: RobotModel, q, qd, u, gravity=-9.81):
    """q̈ by CRBA, the active-region factor and one solve."""
    X = blops.joint_transforms_bl(model, q)
    _, _, f0 = blops.rnea_fwd_bl(model, X, qd, None, gravity)
    c, _ = blops.rnea_bwd_bl(model, X, f0, qd)
    cols = _chol_factor_act(blops.crba_bl(model, X), model.n)
    return _chol_solve_act(cols, (u - c)[:, None])[:, 0]


def minv_ud_plain(model: RobotModel, q):
    """K2: U (6, n, B) and D⁻¹ (n, B)."""
    B = q.shape[-1]
    U, Dinv = blops.minv_UD_bl(model, blops.joint_transforms_bl(model, q))
    return (torch.stack([u.expand(6, B) for u in U], dim=1),
            torch.cat([d.expand(1, B) for d in Dinv]))


def minv_cols_plain(model: RobotModel, q, U, Dinv, cb=None):
    """K3 over every column block: the upper-triangular rows of M⁻¹
    (n, n, B)."""
    n = model.n
    cb = _minv_block(model, cb)
    X = blops.joint_transforms_bl(model, q)
    Ul, Dl = _as_list(U, n), [Dinv[i:i + 1] for i in range(n)]
    return torch.cat([blops.minv_cols_bl(model, X, Ul, Dl, c0, w)
                      for c0, w in _blocks(n, cb)], dim=1)


def af_plain(model: RobotModel, q, qd, qdd, v, gravity=-9.81):
    X = blops.joint_transforms_bl(model, q)
    _, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity,
                                v_known=_as_list(v.to(q.dtype), model.n))
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    return torch.stack(a, dim=1), torch.stack(f, dim=1)


def vaf_plain(model: RobotModel, q, qd, qdd, gravity=-9.81):
    X = blops.joint_transforms_bl(model, q)
    v, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity)
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    return (torch.stack(v, dim=1), torch.stack(a, dim=1),
            torch.stack(f, dim=1))


def grad_cols_plain(model: RobotModel, q, qd, v, a, f, gravity=-9.81,
                    cb=None, Minv=None, sides=_SIDES):
    """K5 over every column block: (∂c/∂q, ∂c/∂q̇), or with ``Minv`` the
    fused finish (−M⁻¹·∂c over each block's nonzero rows), each (n,n,B) —
    one per side of ``sides``. Stage tensors in bf16 are read in q's
    dtype."""
    n = model.n
    _side_bits(sides)
    cb = _col_block(model, cb)
    X = blops.joint_transforms_bl(model, q)
    vl, al, fl = (_as_list(t.to(q.dtype), n) for t in (v, a, f))
    if Minv is not None:
        Minv = Minv.to(q.dtype)
    outs = {side: [] for side in sides}
    for c0, w in _blocks(n, cb):
        for side in sides:
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
    return tuple(torch.cat(outs[side], dim=1) for side in sides)


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
        launch(*design("bias_and_v", "grid_bias_v"), model,
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
        launch(*design("minv_dense"), model,
                (q.data_ptr(), ptr(rhs), Minv.data_ptr(), ptr(qdd)), B)
    return (Minv,) if rhs is None else (Minv, qdd)


def minv_qdd_af_dense_staged(model: RobotModel, q, qd, umc, v,
                             gravity=-9.81):
    """K2″: K2′ and K4 in one kernel — M⁻¹ (n, n, B) and the second sweep's
    a, f (6, n, B) at q̈ = M⁻¹·umc, which never leaves the thread; ``umc``
    is u − c, ``v`` K1's (6, n, B)."""
    if on_cpu(q):
        return minv_af_plain(model, q, qd, umc, v, gravity)
    B = check(model, [q, qd, umc])
    n = model.n
    check_staged(model, "v", v, (6, n, B))
    Minv = empty(model, n, n, B)
    a, f = empty(model, 6, n, B), empty(model, 6, n, B)
    if B:
        launch("minv_af", "grid_minv_af", model,
                (q.data_ptr(), qd.data_ptr(), umc.data_ptr(), v.data_ptr(),
                 Minv.data_ptr(), a.data_ptr(), f.data_ptr()), B,
                float(gravity))
    return Minv, a, f


def fd_dense_staged(model: RobotModel, q, qd, u, gravity=-9.81):
    """Forward dynamics in one kernel without M⁻¹: bias RNEA, CRBA, the
    column Cholesky and one forward and back substitution; q̈ (n, B)."""
    if on_cpu(q):
        return fd_dense_plain(model, q, qd, u, gravity)
    B = check(model, [q, qd, u])
    qdd = empty(model, model.n, B)
    if B:
        launch("fd_dense", "grid_fd_dense", model,
                (q.data_ptr(), qd.data_ptr(), u.data_ptr(), qdd.data_ptr()),
                B, float(gravity))
    return qdd


def minv_ud_staged(model: RobotModel, q):
    """K2: U (6, n, B) and D⁻¹ (n, B) of the articulated sweep."""
    if on_cpu(q):
        return minv_ud_plain(model, q)
    B = check(model, [q])
    U, Dinv = empty(model, 6, model.n, B), empty(model, model.n, B)
    if B:
        launch("minv_ud", "grid_minv_ud", model,
                (q.data_ptr(), U.data_ptr(), Dinv.data_ptr()), B)
    return U, Dinv


def minv_cols_staged(model: RobotModel, q, U, Dinv, cb=None):
    """K3: every column block of the upper-triangular M⁻¹ rows (n, n, B)
    in one launch."""
    if on_cpu(q):
        return minv_cols_plain(model, q, U, Dinv, cb)
    B = check(model, [q])
    n = model.n
    check_staged(model, "U", U, (6, n, B))
    check_staged(model, "Dinv", Dinv, (n, B))
    cb = _minv_block(model, cb)
    M = empty(model, n, n, B)
    if B:
        launch("minv_cols", "grid_minv_cols", model,
                (q.data_ptr(), U.data_ptr(), Dinv.data_ptr(), M.data_ptr()),
                B, cb)
    return M


def _stage_dtype_of(t):
    """The dtype staged inputs must share: bf16, else the model's (None)."""
    return torch.bfloat16 if t.dtype == torch.bfloat16 else None


def af_staged(model: RobotModel, q, qd, qdd, v, gravity=-9.81):
    """K4: a, f (6, n, B) at the true q̈, v (6, n, B, in the model's dtype
    or bf16) reused."""
    if on_cpu(q):
        return af_plain(model, q, qd, qdd, v, gravity)
    B = check(model, [q, qd, qdd])
    check_staged(model, "v", v, (6, model.n, B), _stage_dtype_of(v))
    s16 = v.dtype == torch.bfloat16
    a, f = empty(model, 6, model.n, B), empty(model, 6, model.n, B)
    if B:
        launch(*design("af_bf16" if s16 else "af", "grid_af"), model,
                (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), v.data_ptr(),
                 a.data_ptr(), f.data_ptr()), B, int(s16), float(gravity))
    return a, f


def vaf_staged(model: RobotModel, q, qd, qdd, gravity=-9.81):
    """∂ID's sweep: v, a, f (6, n, B), f summed to the root."""
    if on_cpu(q):
        return vaf_plain(model, q, qd, qdd, gravity)
    B = check(model, [q, qd, qdd])
    v, a, f = (empty(model, 6, model.n, B) for _ in range(3))
    if B:
        launch(*design("vaf"), model,
                (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), v.data_ptr(),
                 a.data_ptr(), f.data_ptr()), B, float(gravity))
    return v, a, f


def grad_cols_staged(model: RobotModel, q, qd, v, a, f, gravity=-9.81,
                     cb=None, Minv=None, sides=_SIDES):
    """K5: every column block of the ``sides`` in one launch — ∂c/∂q and
    ∂c/∂q̇, or with ``Minv`` (n, n, B) the fused −M⁻¹·∂c finish; one
    (n, n, B) tensor per side. v, a, f (and Minv) share one dtype: the
    model's, or bf16."""
    if on_cpu(q):
        return grad_cols_plain(model, q, qd, v, a, f, gravity, cb, Minv,
                               sides)
    B = check(model, [q, qd])
    n = model.n
    sdt = _stage_dtype_of(v)
    for name, t in (("v", v), ("a", a), ("f", f)):
        check_staged(model, name, t, (6, n, B), sdt)
    if Minv is not None:
        check_staged(model, "Minv", Minv, (n, n, B), sdt)
    cb = _col_block(model, cb)
    bits = _side_bits(sides)
    outs = {side: empty(model, n, n, B) for side in sides}
    name = (("grad_cols" if Minv is None else "grad_cols_finish")
            + ("_side" if len(sides) == 1 else "")
            + ("_bf16" if sdt is not None else ""))
    if B:
        launch(*design(name, "grid_grad_cols"), model,
                (q.data_ptr(), qd.data_ptr(), v.data_ptr(), a.data_ptr(),
                 f.data_ptr(), ptr(Minv), ptr(outs.get("q")),
                 ptr(outs.get("qd"))), B, cb, bits, int(sdt is not None),
                float(gravity))
    return tuple(outs[side] for side in sides)


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------
def _k5(model, q, qd, v, a, f, gravity, cb, Minv, merge_sides):
    """K5 merged (one launch) or once per side; {side: (n, n, B)}."""
    out = {}
    for sides in ((_SIDES,) if merge_sides else (("q",), ("qd",))):
        out.update(zip(sides, grad_cols_staged(model, q, qd, v, a, f,
                                               gravity, cb, Minv, sides)))
    return out


def id_grad_staged(model: RobotModel, q, qd, qdd, gravity=-9.81, cb=None,
                   stage_dtype=None, merge_sides=True):
    """Staged ∂ID: (∂c/∂q, ∂c/∂q̇), each (n, n, B). ``merge_sides=False``
    launches K5 once per side; ``stage_dtype=torch.bfloat16`` stages v, a,
    f in bf16 for K5."""
    _check_stage_dtype(stage_dtype)
    v, a, f = vaf_staged(model, q, qd, qdd, gravity)
    if stage_dtype is not None:
        v, a, f = to_stage(v), to_stage(a), to_stage(f)
    out = _k5(model, q, qd, v, a, f, gravity, cb, None, merge_sides)
    return out["q"], out["qd"]


def minv_staged(model: RobotModel, q, cb=None):
    """M⁻¹ (n, n, B) by the articulated recursion in stages: K2 (U, D⁻¹),
    K3 (every column block of ``cb`` in one launch), then the densify in
    torch."""
    U, Dinv = minv_ud_staged(model, q)
    upper = minv_cols_staged(model, q, U, Dinv, cb)
    return blops.densify_rows([upper[i] for i in range(model.n)])


def fd_staged(model: RobotModel, q, qd, u, gravity=-9.81, cb=None):
    """Forward dynamics by the composition in stages: K1, ``minv_staged``,
    then q̈ = M⁻¹(u − c) in torch; ``cb`` is K3's."""
    c, _ = bias_and_v_staged(model, q, qd, gravity)
    return blops.matvecN(minv_staged(model, q, cb), u - c)


def fd_grad_staged(model: RobotModel, q, qd, u, gravity=-9.81, cb=None,
                   fuse_finish=None, stage_dtype=None, merge_sides=True,
                   minv_impl="dense", merge_af=False):
    """Staged ∇FD: (∂q̈/∂q, ∂q̈/∂q̇), each (n, n, B) — by default K1, K2′
    (dense M⁻¹ and q̈), K4, K5 with the fused finish. The options, with the
    JAX package's names and defaults (module docstring): ``minv_impl``
    ("dense" or "recursion"), ``merge_af``, ``fuse_finish`` (None: fused),
    ``merge_sides`` and ``stage_dtype`` (None or torch.bfloat16: v and M⁻¹
    staged in bf16 before K4, a and f after it; q̈ stays in q's dtype)."""
    if minv_impl not in ("dense", "recursion"):
        raise ValueError(f"minv_impl must be 'dense' or 'recursion', got "
                         f"{minv_impl!r}")
    _check_stage_dtype(stage_dtype)
    cb = _col_block(model, cb, fuse_finish=fuse_finish)
    fuse = fuse_finish is None or bool(fuse_finish)
    c, v = bias_and_v_staged(model, q, qd, gravity)
    a = None
    if minv_impl == "recursion":
        Minv = minv_staged(model, q)
        qdd = blops.matvecN(Minv, u - c)
    elif merge_af:
        Minv, a, f = minv_qdd_af_dense_staged(model, q, qd, u - c, v,
                                              gravity)
    else:
        Minv, qdd = minv_qdd_dense_staged(model, q, u - c)
    if stage_dtype is not None:
        v, Minv = to_stage(v), to_stage(Minv)
    if a is None:
        a, f = af_staged(model, q, qd, qdd, v, gravity)
    if stage_dtype is not None:
        a, f = to_stage(a), to_stage(f)
    out = _k5(model, q, qd, v, a, f, gravity, cb, Minv if fuse else None,
              merge_sides)
    if fuse:
        return out["q"], out["qd"]
    Minv = Minv.to(q.dtype)
    return tuple(blops.matmatN(Minv, out[side], negate=True)
                 for side in _SIDES)
