"""The multi-dof single-kernel families and their plain versions.

Counterparts of ``gridcodegenerator_tpu/ops/kernels/multidof_fused.py``
(``md_id_fused`` :879, ``md_aba_fused`` :377, ``md_id_grad_fused`` :771,
``md_fd_grad_fused`` :791, ``md_fd_fused`` :894) with the same batch-last
signatures: q (nq, B), q̇, q̈ and u (nv, B). Each wrapper

* on a CPU tensor runs its plain version (``*_plain``, built from
  :mod:`..md_blops`), the CPU counterpart of the JAX package's
  ``force_xla`` bodies;
* on a CUDA tensor launches its hand-written kernel (``csrc/md.cu``, built
  for the robot's joint types at first use by :mod:`._build`), or raises.
  There is no fallback from the kernel to the plain version.

The two gradient families hold O(n·nv + nv²) values a state on one thread;
their kernels are built only up to ``_build.MAX_MD_GRAD_NV`` velocity
coordinates (``_build.md_dense_grads``), and the batched entries
(:mod:`..multidof`) route past it to the staged pipeline
(:mod:`.multidof_staged`). On CPU tensors the plain versions run at any
size.
"""

from __future__ import annotations

from .. import md_blops
from ._launch import check_md, empty, launch, on_cpu


# --------------------------------------------------------------------------
# plain versions (any device)
# --------------------------------------------------------------------------
def md_id_plain(model, q, qd, qdd=None, gravity=-9.81):
    X = md_blops.md_transforms_bl(model, q)
    c, *_ = md_blops.md_rnea_bl(model, X, qd, qdd, gravity)
    return c


def md_aba_plain(model, q, qd, u, gravity=-9.81):
    return md_blops.md_aba_bl(model, q, qd, u, gravity)


def md_id_grad_plain(model, q, qd, qdd=None, gravity=-9.81):
    X = md_blops.md_transforms_bl(model, q)
    _, v, a, f = md_blops.md_rnea_bl(model, X, qd, qdd, gravity)
    return md_blops.md_id_grad_bl(model, X, qd, v, a, f, gravity)


def md_fd_grad_plain(model, q, qd, u, gravity=-9.81):
    return md_blops.md_fd_grad_bl(model, q, qd, u, gravity)


def md_fd_plain(model, q, qd, u, gravity=-9.81):
    return md_blops.md_fd_crba_bl(model, q, qd, u, gravity)


# --------------------------------------------------------------------------
# public wrappers (batch-last: q (nq, B), the others (nv, B))
# --------------------------------------------------------------------------
def md_id_fused(model, q, qd, qdd=None, gravity=-9.81):
    """Generalized RNEA: q (nq,B), q̇[, q̈] (nv,B) → c (nv,B); ``qdd=None``
    is the bias force."""
    if on_cpu(q):
        return md_id_plain(model, q, qd, qdd, gravity)
    B = check_md(model, q, [qd] if qdd is None else [qd, qdd])
    c = empty(model, model.nv, B)
    if B:
        launch("md_id", "grid_md_rnea", model,
               (q.data_ptr(), qd.data_ptr(),
                None if qdd is None else qdd.data_ptr(), c.data_ptr()),
               B, float(gravity))
    return c


def md_aba_fused(model, q, qd, u, gravity=-9.81):
    """Generalized ABA: q (nq,B), q̇, u (nv,B) → q̈ (nv,B)."""
    if on_cpu(q):
        return md_aba_plain(model, q, qd, u, gravity)
    B = check_md(model, q, [qd, u])
    qdd = empty(model, model.nv, B)
    if B:
        launch("md_aba", "grid_md_aba", model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(), qdd.data_ptr()),
               B, float(gravity))
    return qdd


def md_fd_fused(model, q, qd, u, gravity=-9.81):
    """Generalized FD by the mass matrix: q (nq,B), q̇, u (nv,B) → q̈ (nv,B)
    — bias RNEA, CRBA and a dense (nv, nv) Cholesky solve in one kernel."""
    if on_cpu(q):
        return md_fd_plain(model, q, qd, u, gravity)
    B = check_md(model, q, [qd, u])
    qdd = empty(model, model.nv, B)
    if B:
        launch("md_fd", "grid_md_fd", model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(), qdd.data_ptr()),
               B, float(gravity))
    return qdd


def md_id_grad_fused(model, q, qd, qdd=None, gravity=-9.81):
    """Tangent-space ∂ID after an in-kernel v/a/f sweep at q̈ (zero for
    ``qdd=None``): → (∂τ/∂δq, ∂τ/∂q̇), each (nv,nv,B)."""
    if on_cpu(q):
        return md_id_grad_plain(model, q, qd, qdd, gravity)
    B = check_md(model, q, [qd] if qdd is None else [qd, qdd])
    dq = empty(model, model.nv, model.nv, B)
    dqd = empty(model, model.nv, model.nv, B)
    if B:
        launch("md_id_grad", "grid_md_id_grad", model,
               (q.data_ptr(), qd.data_ptr(),
                None if qdd is None else qdd.data_ptr(), dq.data_ptr(),
                dqd.data_ptr()), B, float(gravity))
    return dq, dqd


def md_fd_grad_fused(model, q, qd, u, gravity=-9.81):
    """Tangent-space ∇FD in one launch: → (∂q̈/∂δq, ∂q̈/∂q̇, ∂q̈/∂u), each
    (nv,nv,B)."""
    if on_cpu(q):
        return md_fd_grad_plain(model, q, qd, u, gravity)
    B = check_md(model, q, [qd, u])
    outs = tuple(empty(model, model.nv, model.nv, B) for _ in range(3))
    if B:
        launch("md_fd_grad", "grid_md_fd_grad", model,
               (q.data_ptr(), qd.data_ptr(), u.data_ptr(),
                *(o.data_ptr() for o in outs)), B, float(gravity))
    return outs
