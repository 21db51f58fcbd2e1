"""The single-thread second-order kernels and their plain versions.

Counterparts of ``gridcodegenerator_tpu/ops/kernels/so_fused.py``
(``fd_hessian_vp_fused``, so_fused.py:195; ``fd_hessian_fused``, :220)
with the same batch-last signatures and output layouts: λᵀ·H is
(3n, 3n, B) and H is (n, 3n, 3n, B), the direction axis last among the
structure axes. Each wrapper

* on a CPU tensor runs its plain version (:mod:`..so`, forward mode over
  the plain ∇FD body, ``ops.so.jvp``);
* on a CUDA tensor launches its kernel (``csrc/so.cu``), or raises.

Where ``_build.dense_hessian_vp(n)`` is false λᵀ·H takes the staged
pipeline (:mod:`.so_staged`), and where ``_build.dense_hessian(n)`` is false
the full tensor is n staged λᵀ·H calls (the JAX package has no kernel
there), on the CPU and on the card alike, as the JAX API routes past its
VMEM gates (api.py:499, :524-531).
"""

from __future__ import annotations

from ...models.robot import RobotModel
from .. import so
from . import so_staged
from ._build import dense_hessian, dense_hessian_vp
from ._launch import check, empty, launch, on_cpu


def fd_hessian_vp_plain(model: RobotModel, q, qd, u, lam, gravity=-9.81):
    return so.forward_dynamics_hessian_bl(model, q, qd, u, gravity, lam=lam)


def fd_hessian_plain(model: RobotModel, q, qd, u, gravity=-9.81):
    return so.forward_dynamics_hessian_bl(model, q, qd, u, gravity)


def fd_hessian_vp_fused(model: RobotModel, q, qd, u, lam, gravity=-9.81):
    """λᵀ·∂²q̈/∂x∂x, the DDP backward pass's curvature term: q, q̇, u, λ
    (n, B) → (3n, 3n, B). One launch over a (⌈B/128⌉, 3n) grid: each thread
    runs the ∇FD pipeline and M⁻¹ in dual numbers along one coordinate
    direction of one state."""
    if not dense_hessian_vp(model.n):
        if not on_cpu(q):
            # λ reaches no stage kernel's checks, only lamM = M⁻¹λ
            check(model, [q, qd, u, lam])
        return so_staged.fd_hessian_vp_staged(model, q, qd, u, lam, gravity)
    if on_cpu(q):
        return fd_hessian_vp_plain(model, q, qd, u, lam, gravity)
    B = check(model, [q, qd, u, lam])
    n3 = 3 * model.n
    out = empty(model, n3, n3, B)
    if B:
        launch("hessian_vp", "grid_hessian", model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(), lam.data_ptr(),
                out.data_ptr()), B, float(gravity))
    return out


def fd_hessian_fused(model: RobotModel, q, qd, u, gravity=-9.81):
    """The full ∂²q̈/∂x∂x: q, q̇, u (n, B) → (n, 3n, 3n, B), one launch as
    :func:`fd_hessian_vp_fused` without the contraction."""
    if not dense_hessian(model.n):
        return so_staged.fd_hessian_staged(model, q, qd, u, gravity)
    if on_cpu(q):
        return fd_hessian_plain(model, q, qd, u, gravity)
    B = check(model, [q, qd, u])
    n = model.n
    out = empty(model, n, 3 * n, 3 * n, B)
    if B:
        launch("hessian", "grid_hessian", model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(), None,
                out.data_ptr()), B, float(gravity))
    return out
