"""True free-flyer (quaternion floating base) dynamics, batched.

The port's counterpart of ``gridcodegenerator_tpu/ops/freeflyer.py``: a
fixed-base articulated arm (the port's :class:`RobotModel`) plus the base
link's own spatial inertia, the base a 6-dof joint with S₀ = I₆ and a
quaternion attitude — no Euler-angle singularity.

Conventions (the JAX package's): spatial vectors are [angular; linear] in
base-link coordinates; ``vb`` is the base twist in base coordinates;
quaternions are (w, x, y, z), world ← base; the recursions run with the
fictitious base acceleration a₀' = [0; −g_b] (g_b = R_wbᵀ·[0, 0, gravity]),
so the solved base acceleration is the twist's componentwise derivative v̇b.

:func:`fb_forward_dynamics_batched` takes batch-first states and runs, on
the batch-last layout, the floating-base ABA (``impl="auto"``) or the
(6+n)² mass-matrix Cholesky (``impl="chol"``) of
:mod:`.kernels.contact_fused`: the CUDA kernels on CUDA tensors, their
plain versions on CPU tensors. The per-state functions (``fb_bias``,
``fb_mass_matrix``, ``fb_step``, the gradients, the energy) wait for
ROADMAP Queue 1, 'The per-state tier and differentiability'.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..api import _check_impl, _cols, _unflat
from ..models.robot import (RobotModel, from_jax_arrays,
                            robot_model_from_description)
from ..models.urdf import RobotDescription
from .kernels import contact_fused as _cf


# ------------------------------------------------------------- quaternions
def quat_to_rot(quat):
    """(..., 4) (w, x, y, z) → R (..., 3, 3), world ← base; unit norm
    assumed."""
    w, x, y, z = quat.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def quat_mul(a, b):
    """(..., 4) ⊗ (..., 4) → (..., 4)."""
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    return torch.cat([aw * bw - (av * bv).sum(-1, keepdim=True),
                      aw * bv + bw * av + torch.linalg.cross(av, bv)], -1)


def quat_exp_body(omega_dt):
    """exp(½·ω̂·|ω|dt): the unit quaternion that advances the attitude by a
    body angular velocity ω over dt, (..., 3) → (..., 4); safe at ω → 0."""
    half = 0.5 * omega_dt
    ang = torch.sqrt((half * half).sum(-1, keepdim=True) + 1e-30)
    return torch.cat([torch.cos(ang), torch.sin(ang) / ang * half], -1)


def rot_to_quat(R):
    """R (..., 3, 3) → (w, x, y, z) (..., 4), by the trace (adequate away
    from w ≈ 0)."""
    w = 0.5 * torch.sqrt(torch.clamp(
        1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], min=1e-12))
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    q = torch.stack([w, x, y, z], -1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# ------------------------------------------------------------------- model
@dataclass(frozen=True, eq=False)
class FreeFlyerModel:
    """A fixed-base arm and the base link's spatial inertia
    (``RobotDescription.base_inertia``), on one device in one dtype."""

    arm: RobotModel
    I_base: torch.Tensor  # (6, 6)

    @property
    def n(self) -> int:
        return self.arm.n

    @property
    def dtype(self) -> torch.dtype:
        return self.arm.dtype

    @property
    def device(self) -> torch.device:
        return self.arm.device

    @property
    def topology(self):
        return self.arm.topology

    @property
    def joint_types(self) -> tuple:
        return self.arm.joint_types

    @property
    def name(self) -> str:
        return self.arm.name

    def to(self, device=None, dtype=None) -> "FreeFlyerModel":
        """A copy on ``device`` in ``dtype`` (either may be None to keep the
        current one)."""
        return dataclasses.replace(
            self, arm=self.arm.to(device, dtype),
            I_base=self.I_base.to(device=device, dtype=dtype))

    @functools.cached_property
    def packed(self) -> torch.Tensor:
        """The arm's packed constants (``RobotModel.packed``) followed by
        I_base (36 values): the buffer the kernels of ``csrc/ff.cu`` stage
        into shared memory."""
        return torch.cat([self.arm.packed,
                          self.I_base.reshape(-1)]).contiguous()


def free_flyer_model(desc: RobotDescription, dtype=torch.float64,
                     device="cuda", accurate_trig: bool = False
                     ) -> FreeFlyerModel:
    """The free flyer of a description whose joints are all single-dof:
    its arm and its base inertia, in float64 unless ``dtype`` says
    otherwise (the JAX package's default)."""
    arm = robot_model_from_description(desc, dtype=dtype, device=device,
                                       accurate_trig=accurate_trig)
    return FreeFlyerModel(arm=arm, I_base=torch.tensor(
        np.asarray(desc.base_inertia), dtype=dtype, device=arm.device))


def ff_from_jax_arrays(arm_arrays: dict, I_base, parents, joint_types,
                       name: str, device="cuda") -> FreeFlyerModel:
    """The port's free flyer from the leaves of a JAX ``FreeFlyerModel`` as
    numpy arrays: its arm's fields (as for
    :func:`..models.robot.from_jax_arrays`) and ``I_base``, in their
    dtype."""
    arm = from_jax_arrays(arm_arrays, parents, joint_types, name,
                          device=device)
    return FreeFlyerModel(arm=arm, I_base=torch.tensor(
        np.asarray(I_base), dtype=arm.dtype, device=arm.device))


# ------------------------------------------------------- batched entry
def _check_ff_states(model, states, names):
    """Fail fast: quat ends in 4, vb in 6, pos in 3, q, q̇ and τ in n, and
    all share one batch shape."""
    widths = {"quat": 4, "pos": 3, "vb": 6}
    for nm, s in zip(names, states):
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor, got {type(s)}")
        want = widths.get(nm, model.n)
        if s.dim() == 0 or s.shape[-1] != want:
            raise ValueError(
                f"{nm} must have trailing dimension {want} (robot "
                f"'{model.name}': n={model.n}), got shape {tuple(s.shape)}")
    if len({tuple(s.shape[:-1]) for s in states}) > 1:
        raise ValueError(
            "state batch shapes disagree: "
            + ", ".join(f"{nm}={tuple(s.shape)}"
                        for nm, s in zip(names, states)))


def fb_forward_dynamics_batched(model: FreeFlyerModel, quat, q, vb, qd, tau,
                                gravity=-9.81, impl="auto"):
    """Free-flyer forward dynamics over leading batch axes: quat (..., 4),
    q, q̇, τ (..., n), vb (..., 6) → (v̇b (..., 6), q̈ (..., n)). The base
    is unactuated.

    ``impl="auto"`` (or ``"cuda"``, which needs CUDA tensors) runs the
    floating-base ABA, O(n) a state with one 6×6 base solve;
    ``impl="chol"`` the (6+n)² mass matrix and its Cholesky solve."""
    names = ("quat", "q", "vb", "qd", "tau")
    states = (quat, q, vb, qd, tau)
    _check_ff_states(model, states, names)
    _check_impl("auto" if impl == "chol" else impl, q)
    kern = _cf.fb_fd_fused if impl == "chol" else _cf.fb_aba_fused
    dvb, qdd = kern(model, *(_cols(x) for x in states), gravity)
    batch = tuple(q.shape[:-1])
    return _unflat(dvb, batch), _unflat(qdd, batch)
