"""Public API: batched first- and second-order dynamics on torch tensors.

The port's counterpart of ``gridcodegenerator_tpu/api.py``. Every function
takes a single state ``(n,)`` or any batch ``(..., n)`` of states, moves it
to the batch-last (n, B) layout the kernels use, and returns the JAX API's
shapes.

Implementation selection (``impl=``):
  * ``"auto"`` — the CUDA kernel for CUDA tensors, the plain PyTorch
    batch-last version for CPU tensors (the counterpart of the JAX
    package's ``"bl"`` path). A CUDA tensor never reaches the plain version.
  * ``"cuda"`` — the CUDA kernel; CPU tensors raise (no downgrade).
``"vmap"`` (the per-state tier) and ``f_ext`` are not ported yet.
"""

from __future__ import annotations

import torch

from .models.robot import RobotModel
from .ops.kernels import fused, so_fused

_IMPLS = ("auto", "cuda")
# ROADMAP items are named by title, which a renumbering leaves as it is
_PER_STATE_TIER = ("ROADMAP Queue 1, 'The per-state tier and "
                   "differentiability'")


def _check_impl(impl: str, x: torch.Tensor) -> None:
    """Validate ``impl=`` (the JAX API's ``_resolve_impl``); the kernel
    wrappers themselves pick the CUDA kernel or the plain version from the
    states' device."""
    if impl == "vmap":
        raise NotImplementedError(
            f"impl='vmap' is not ported yet: {_PER_STATE_TIER}")
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got states on {x.device}")


def _no_fext(f_ext) -> None:
    if f_ext is not None:
        raise NotImplementedError(
            f"f_ext is not ported yet: {_PER_STATE_TIER}")


def _check_states(model, states, names):
    """Fail fast with a typed error on malformed state arrays: every state
    must end in the robot's joint dimension and share one batch shape."""
    n = model.n
    named = [(nm, s) for nm, s in zip(names, states) if s is not None]
    names = [nm for nm, _ in named]
    for nm, s in named:
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor, got {type(s)}")
    shapes = [tuple(s.shape) for _, s in named]
    for name, shp in zip(names, shapes):
        if len(shp) == 0 or shp[-1] != n:
            raise ValueError(
                f"{name} must have trailing dimension n={n} "
                f"(robot '{model.name}'), got shape {shp}")
    if len({shp[:-1] for shp in shapes}) > 1:
        raise ValueError(
            f"state batch shapes disagree: "
            + ", ".join(f"{nm}={shp}" for nm, shp in zip(names, shapes)))


def _cols(x):
    """(..., k) batch first → (k, B) batch last, contiguous; None stays
    None."""
    return None if x is None else x.reshape(-1, x.shape[-1]).T.contiguous()


def _unflat(out, batch_shape):
    """(k…, B) batch last → batch_shape + (k…) batch first."""
    out = out.movedim(-1, 0).contiguous()
    return out.reshape(batch_shape + tuple(out.shape[1:]))


def _run(model, states, kernel):
    """Boundary adapter: (..., n) batch-first user tensors → (n, B)
    batch-last kernel layout, ``kernel(model, *states)``, and back."""
    n = model.n
    batch_shape = tuple(states[0].shape[:-1])
    cols = [s.reshape(-1, n).T.contiguous() for s in states]
    out = kernel(model, *cols)
    out = out.movedim(-1, 0).contiguous()
    return out.reshape(batch_shape + tuple(out.shape[1:]))


# --------------------------------------------------------------------------
# The first-order families
# --------------------------------------------------------------------------
def inverse_dynamics(model: RobotModel, q, qd, qdd, *, gravity: float = -9.81,
                     impl: str = "auto", f_ext=None):
    """c(q, q̇, q̈): joint torques by RNEA, (..., n)."""
    _check_states(model, (q, qd, qdd), ("q", "qd", "qdd"))
    _no_fext(f_ext)
    _check_impl(impl, q)
    return _run(model, (q, qd, qdd),
                lambda m, *s: fused.inverse_dynamics_fused(m, *s,
                                                           gravity=gravity))


def bias_force(model: RobotModel, q, qd, *, gravity: float = -9.81,
               impl: str = "auto"):
    """c(q, q̇) with q̈ = 0, (..., n)."""
    _check_states(model, (q, qd), ("q", "qd"))
    _check_impl(impl, q)
    return _run(model, (q, qd),
                lambda m, *s: fused.inverse_dynamics_fused(m, *s, None,
                                                           gravity=gravity))


def direct_minv(model: RobotModel, q, *, dense: bool = True,
                impl: str = "auto"):
    """Analytic M⁻¹(q), dense symmetric, (..., n, n)."""
    _check_states(model, (q,), ("q",))
    if not dense:
        raise NotImplementedError(
            "direct_minv(dense=False), the raw upper triangle, is not ported "
            "yet: ROADMAP Queue 1, 'The rest of the first-order API "
            "contract'")
    _check_impl(impl, q)
    return _run(model, (q,), fused.minv_fused)


def forward_dynamics(model: RobotModel, q, qd, u, *, gravity: float = -9.81,
                     impl: str = "auto", f_ext=None):
    """q̈ = M⁻¹ (u − c(q, q̇)) by the articulated-body algorithm, (..., n)
    — the JAX package's TPU route (``api._k_fd``)."""
    _check_states(model, (q, qd, u), ("q", "qd", "u"))
    _no_fext(f_ext)
    _check_impl(impl, q)
    return _run(model, (q, qd, u),
                lambda m, *s: fused.forward_dynamics_aba_fused(
                    m, *s, gravity=gravity))


def inverse_dynamics_gradient(model: RobotModel, q, qd, qdd, *,
                              gravity: float = -9.81, impl: str = "auto",
                              f_ext=None):
    """[∂c/∂q | ∂c/∂q̇] as (..., n, 2n)."""
    _check_states(model, (q, qd, qdd), ("q", "qd", "qdd"))
    _no_fext(f_ext)
    _check_impl(impl, q)
    return _run(model, (q, qd, qdd), lambda m, *s: torch.cat(
        fused.id_grad_fused(m, *s, gravity=gravity), dim=1))


def forward_dynamics_gradient(model: RobotModel, q, qd, u, *,
                              gravity: float = -9.81, impl: str = "auto",
                              f_ext=None):
    """[∂q̈/∂q | ∂q̈/∂q̇] as (..., n, 2n) — the north-star op."""
    _check_states(model, (q, qd, u), ("q", "qd", "u"))
    _no_fext(f_ext)
    _check_impl(impl, q)
    return _run(model, (q, qd, u), lambda m, *s: torch.cat(
        fused.fd_grad_fused(m, *s, gravity=gravity), dim=1))


# --------------------------------------------------------------------------
# Second order
# --------------------------------------------------------------------------
def forward_dynamics_gradient_full(model: RobotModel, q, qd, u, *,
                                   gravity: float = -9.81,
                                   impl: str = "auto"):
    """[∂q̈/∂q | ∂q̈/∂q̇ | ∂q̈/∂u] as (..., n, 3n): the ∇FD route's two
    blocks and the M⁻¹ route's ∂q̈/∂u = M⁻¹."""
    _check_states(model, (q, qd, u), ("q", "qd", "u"))
    _check_impl(impl, q)
    return _run(model, (q, qd, u), lambda m, q_, qd_, u_: torch.cat(
        [*fused.fd_grad_fused(m, q_, qd_, u_, gravity=gravity),
         fused.minv_fused(m, q_)], dim=1))


def forward_dynamics_hessian(model: RobotModel, q, qd, u, *,
                             gravity: float = -9.81, impl: str = "auto"):
    """∂²q̈/∂x∂x, x = (q, q̇, u), as (..., n, 3n, 3n), symmetric in the
    trailing pair: the single-thread Hessian kernel while
    ``_build.dense_hessian(n)``, else n staged λᵀ·H calls (λ = e_i)."""
    _check_states(model, (q, qd, u), ("q", "qd", "u"))
    _check_impl(impl, q)
    return _run(model, (q, qd, u),
                lambda m, *s: so_fused.fd_hessian_fused(m, *s,
                                                        gravity=gravity))


def forward_dynamics_hessian_vp(model: RobotModel, q, qd, u, lam, *,
                                gravity: float = -9.81, impl: str = "auto"):
    """λᵀ·∂²q̈/∂x∂x as (..., 3n, 3n) — the DDP backward pass's curvature
    term Σᵢ λᵢ·f_zz[i]. ``lam`` is (..., n), batched like the states. The
    single-thread kernel while ``_build.dense_hessian_vp(n)``, else the
    staged pipeline."""
    _check_states(model, (q, qd, u, lam), ("q", "qd", "u", "lam"))
    _check_impl(impl, q)
    return _run(model, (q, qd, u, lam),
                lambda m, *s: so_fused.fd_hessian_vp_fused(m, *s,
                                                           gravity=gravity))
