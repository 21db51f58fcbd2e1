"""The port's single-kernel first-order families and their plain versions.

Counterparts of ``gridcodegenerator_tpu/ops/kernels/fused.py:270-472`` with
the same batch-last (n, B) signatures. Each wrapper

* on a CPU tensor runs its plain version (``*_plain``, built from
  :mod:`..blops`), the CPU counterpart of the JAX package's ``"bl"`` path;
* on a CUDA tensor launches its hand-written kernel (``csrc/fused.cu``,
  built for the robot's topology at first use by :mod:`._build`), or raises.
  There is no fallback from the kernel to the plain version.

Where ``_build.dense_grads(n)`` is false (past ``MAX_KERNEL_JOINTS``
joints), ∇FD, ∂ID and M⁻¹ route to the staged pipeline (:mod:`.staged`) on
the CPU and on the card alike, as the JAX wrappers do (fused.py:294, :421,
:454); RNEA and ABA are O(n) a state and run on one thread for every robot.

The variants the JAX package keeps for its benchmarks, one launch each:

The recursion ∇FD (``fd_grad_fused``'s default) is a CTA tile
(``csrc/tile.cuh``): a tile of states a CTA, each state's working set in
shared memory through the whole body. The one-thread kernel it replaced
stays as a timed arm, launched when ``_launch.DESIGN`` is ``"thread"`` and
counted under ``fd_grad_thread``.

* ``fd_grad_fused(..., minv_impl="dense")`` — the ∇FD kernel with M⁻¹
  from CRBA, the active-region Cholesky and L⁻ᵀL⁻¹ (:func:`_dense_minv_bl`,
  ``grid_fd_grad_dense``) in place of the articulated recursion; past
  ``MAX_KERNEL_JOINTS`` the staged ∇FD with its default K2′, as JAX.
* ``forward_dynamics_fused`` — q̈ = M⁻¹(u − c), the composition form
  (``grid_fd``); past ``MAX_KERNEL_JOINTS`` the factor-solve
  ``staged.fd_dense_staged``, JAX's first choice past its single tile for
  every n ≤ 49.

JAX's lane-tile branches (fused.py:298-314, :340-347, :375-380, :411-420,
:437-453) run the same bodies on 128-state tiles; here the one-thread
kernels compute those bodies at any n, and the routing follows the card's
timings (``MAX_KERNEL_JOINTS``). Launches are counted in :mod:`._launch`.
"""

from __future__ import annotations

import torch

from ...models.robot import RobotModel
from .. import blops
from ..aba import aba_bl
from . import staged
from ._build import dense_grads
from ._launch import check, design, empty, launch, on_cpu


# --------------------------------------------------------------------------
# plain versions (any device)
# --------------------------------------------------------------------------
def inverse_dynamics_plain(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    c, *_ = blops.rnea_bl(model, q, qd, qdd, gravity)
    return c


def minv_plain(model: RobotModel, q):
    rows, _, _ = blops.minv_bl(model, blops.joint_transforms_bl(model, q))
    return blops.densify_rows(rows)


def id_grad_plain(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    if qdd is None:
        qdd = torch.zeros_like(q)
    X = blops.joint_transforms_bl(model, q)
    v, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity)
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    dq = blops.rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                                  sides=("q",))["q"]
    dqd = blops.rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                                   sides=("qd",))["qd"]
    return dq, dqd


# CRBA + active-region Cholesky + symmetric L⁻ᵀL⁻¹ dense M⁻¹, (model, X) →
# (n, n, B): the M⁻¹ stage of ``minv_impl="dense"`` (JAX's name, fused.py:387)
_dense_minv_bl = staged._dense_minv


def _check_minv_impl(minv_impl):
    if minv_impl not in ("recursion", "dense"):
        raise ValueError(f"minv_impl must be 'recursion' or 'dense', got "
                         f"{minv_impl!r}")


def fd_grad_plain(model: RobotModel, q, qd, u, gravity=-9.81,
                  minv_impl="recursion"):
    _check_minv_impl(minv_impl)
    return blops.fd_grad_bl(
        model, q, qd, u, gravity,
        minv_fn=_dense_minv_bl if minv_impl == "dense" else None)


def forward_dynamics_plain(model: RobotModel, q, qd, u, gravity=-9.81):
    return blops.fd_bl(model, q, qd, u, gravity)


def forward_dynamics_aba_plain(model: RobotModel, q, qd, u, gravity=-9.81):
    return aba_bl(model, q, qd, u, gravity)


# --------------------------------------------------------------------------
# public wrappers (batch-last signatures: states are (n, B))
# --------------------------------------------------------------------------
def inverse_dynamics_fused(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    """RNEA: q, q̇[, q̈] (n,B) → c (n,B); ``qdd=None`` is the bias force."""
    if on_cpu(q):
        return inverse_dynamics_plain(model, q, qd, qdd, gravity)
    states = [q, qd] if qdd is None else [q, qd, qdd]
    B = check(model, states)
    c = empty(model, model.n, B)
    if B:
        launch("inverse_dynamics", "grid_rnea", model,
                (q.data_ptr(), qd.data_ptr(),
                 None if qdd is None else qdd.data_ptr(), c.data_ptr()),
                B, float(gravity))
    return c


def minv_fused(model: RobotModel, q):
    """Analytic M⁻¹: q (n,B) → dense symmetric (n,n,B); past
    ``MAX_KERNEL_JOINTS`` joints, the staged K2′ (CRBA + Cholesky)."""
    if not dense_grads(model.n):
        (M,) = staged.minv_qdd_dense_staged(model, q)
        return M
    if on_cpu(q):
        return minv_plain(model, q)
    B = check(model, [q])
    M = empty(model, model.n, model.n, B)
    if B:
        launch("minv", "grid_minv", model, (q.data_ptr(), M.data_ptr()), B)
    return M


def id_grad_fused(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    """∂ID: returns (∂c/∂q, ∂c/∂q̇), each (n,n,B); past
    ``MAX_KERNEL_JOINTS`` joints, the staged vaf + K5 column blocks."""
    if qdd is None:
        qdd = torch.zeros_like(q)  # S·0 adds nothing: the same as no q̈ term
    if not dense_grads(model.n):
        return staged.id_grad_staged(model, q, qd, qdd, gravity)
    if on_cpu(q):
        return id_grad_plain(model, q, qd, qdd, gravity)
    B = check(model, [q, qd, qdd])
    dq = empty(model, model.n, model.n, B)
    dqd = empty(model, model.n, model.n, B)
    if B:
        launch("id_grad", "grid_id_grad", model,
                (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), dq.data_ptr(),
                 dqd.data_ptr()), B, float(gravity))
    return dq, dqd


def fd_grad_fused(model: RobotModel, q, qd, u, gravity=-9.81,
                  minv_impl="recursion"):
    """∇FD — the north-star kernel: X → RNEA → M⁻¹ → q̈ → second RNEA sweep
    → ∂ID → −M⁻¹·∂c in one launch. Returns (∂q̈/∂q, ∂q̈/∂q̇), each (n,n,B).
    ``minv_impl="dense"`` takes M⁻¹ from CRBA + Cholesky. Past
    ``MAX_KERNEL_JOINTS`` joints, the staged pipeline (K1, K2′, K4, K5
    with the fused finish: four launches) whatever ``minv_impl``."""
    _check_minv_impl(minv_impl)
    if not dense_grads(model.n):
        return staged.fd_grad_staged(model, q, qd, u, gravity)
    if on_cpu(q):
        return fd_grad_plain(model, q, qd, u, gravity, minv_impl)
    B = check(model, [q, qd, u])
    ddq = empty(model, model.n, model.n, B)
    ddqd = empty(model, model.n, model.n, B)
    dense = minv_impl == "dense"
    if B:
        launch(*(("fd_grad_dense", "grid_fd_grad_dense") if dense
                 else design("fd_grad")), model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(), ddq.data_ptr(),
                ddqd.data_ptr()), B, float(gravity))
    return ddq, ddqd


def forward_dynamics_fused(model: RobotModel, q, qd, u, gravity=-9.81):
    """Forward dynamics by the composition q̈ = M⁻¹(u − c): q, q̇, u (n,B)
    → q̈ (n,B), bias RNEA, the articulated M⁻¹ and the matvec in one
    launch; past ``MAX_KERNEL_JOINTS`` joints the factor-solve kernel
    (``staged.fd_dense_staged``), which never forms M⁻¹."""
    if not dense_grads(model.n):
        return staged.fd_dense_staged(model, q, qd, u, gravity)
    if on_cpu(q):
        return forward_dynamics_plain(model, q, qd, u, gravity)
    B = check(model, [q, qd, u])
    qdd = empty(model, model.n, B)
    if B:
        launch("fd", "grid_fd", model,
                (q.data_ptr(), qd.data_ptr(), u.data_ptr(), qdd.data_ptr()),
                B, float(gravity))
    return qdd


def forward_dynamics_aba_fused(model: RobotModel, q, qd, u, gravity=-9.81):
    """Forward dynamics by the articulated-body algorithm: q, q̇, u (n,B) →
    q̈ (n,B), O(n) a state — one thread per state for every robot."""
    if on_cpu(q):
        return forward_dynamics_aba_plain(model, q, qd, u, gravity)
    B = check(model, [q, qd, u])
    qdd = empty(model, model.n, B)
    if B:
        launch("aba", "grid_aba", model,
                (q.data_ptr(), qd.data_ptr(), u.data_ptr(), qdd.data_ptr()),
                B, float(gravity))
    return qdd
