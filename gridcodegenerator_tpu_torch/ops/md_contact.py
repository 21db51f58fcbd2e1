"""Frictional ground contact for the multi-dof stack, batched: ball-hip
quadrupeds and free-floating robots (nq ≠ nv) stepping on the plane.

The port's counterpart of ``gridcodegenerator_tpu/ops/md_contact.py``'s
batched stepper on its kernel route (:505-529): the free-flyer stepper's
formulation on the tangent space,

    v_free = q̇ + dt·M⁻¹(τ − c)          (M from CRBA, with armature)
    G = J·M⁻¹Jᵀ,  PGS cone solve
    q⁺ = q ⊕ dt·v⁺                      (md_tangent_apply's retraction)

with J the world point Jacobian over the nv tangent coordinates. There is
no separate base: a floating robot's torso is its first joint's link, so
torso geoms attach to a regular link index. :func:`md_step_ground_batched`
runs the step kernel of :mod:`.kernels.md_contact_fused` on CUDA tensors
and its plain version on CPU tensors; the effort clamp comes before it and
the projection onto joint limits after it, as tensor operations on the
states' device. The options the JAX package runs on its per-state vmap tier
(terrain, impulse-mode limits, loop, weld and tendon rows, joint friction,
implicit differentiation, ``relax`` ≠ 1) raise ``NotImplementedError``
naming their ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import _check_impl, _cols, _unflat
from .contact import (_KIN_CONTACT, _check_contacts, _contact_mu,
                      _geom_links_ok, clamp_effort)
from .kernels import contact_fused as _cf
from .kernels import md_contact_fused as _mcf
from .multidof import MultiDofModel, _check_md_states


def _md_scalar_coords(model: MultiDofModel):
    """(qidx, vidx) index arrays of the width-1 (hinge/slide) joints' slots
    in q and in the tangent: the coordinates joint limits are defined on
    (ball and free joints have no scalar range)."""
    qidx, vidx = [], []
    for j, (qs, qw) in enumerate(model.q_slices):
        if qw == 1:
            qidx.append(qs)
            vidx.append(model.v_slices[j][0])
    return np.asarray(qidx, np.int64), np.asarray(vidx, np.int64)


def _md_check_limits(model: MultiDofModel, lo, hi):
    """Fail fast if a finite limit sits on a ball- or free-joint coordinate:
    those slots are quaternion components or positions, not angles, and a
    clamp there would corrupt the state."""
    lo_np = np.asarray(torch.as_tensor(lo, dtype=torch.float64).cpu())
    hi_np = np.asarray(torch.as_tensor(hi, dtype=torch.float64).cpu())
    scalar_q = set(int(i) for i in _md_scalar_coords(model)[0])
    bad = [i for i in range(model.nq) if i not in scalar_q
           and (np.isfinite(lo_np[i]) or np.isfinite(hi_np[i]))]
    if bad:
        raise ValueError(
            f"finite joint limits on multi-dof joint coordinates {bad} — "
            "limits apply to hinge/slide coordinates only (ball/free "
            "slots hold quaternion components); set those slots to ±inf")


def md_project_joint_limits(model: MultiDofModel, q, qd, lo, hi):
    """Hard joint limits on a multi-dof robot by projection: clamp the
    scalar-joint coordinates of ``q (..., nq)`` into ``[lo, hi]`` ((nq,)
    each, ±inf on ball and free slots) and zero the outward tangent
    velocity of a clamped joint in ``qd (..., nv)``; → (q, q̇). The stopping
    impulse is not propagated to the rest of the momentum within the step
    (the JAX package's documented approximation)."""
    qidx, vidx = _md_scalar_coords(model)
    if qidx.size == 0:
        return q, qd
    qi = torch.as_tensor(qidx, device=q.device)
    vi = torch.as_tensor(vidx, device=q.device)
    lo_s = torch.as_tensor(lo, dtype=q.dtype, device=q.device)[qi]
    hi_s = torch.as_tensor(hi, dtype=q.dtype, device=q.device)[qi]
    qs = q[..., qi]
    qds = qd[..., vi]
    stop = ((qs >= hi_s) & (qds > 0)) | ((qs <= lo_s) & (qds < 0))
    q, qd = q.clone(), qd.clone()
    q[..., qi] = torch.minimum(torch.maximum(qs, lo_s), hi_s)
    qd[..., vi] = torch.where(stop, torch.zeros_like(qds), qds)
    return q, qd


def md_step_ground_batched(model: MultiDofModel, q, qd, tau, dt, links,
                           offsets, mu=0.8, ground_z=0.0, gravity=-9.81,
                           iters: int = 30, erp: float = 0.2,
                           margin: float = 1e-3, restitution: float = 0.0,
                           limits=None, effort=None,
                           limit_mode: str = "project",
                           impl: str = "auto", diff_mode: str = "unroll",
                           relax: float = 1.0, terrain=None,
                           ground_geoms=None, mu_ground=None, loops=None,
                           welds=None, frictionloss=None, softness=None,
                           tendons=None):
    """B multi-dof frictional ground environments advanced by one step:
    ``q (B, nq)``, ``qd`` and ``tau (B, nv)`` → ((q⁺, q̇⁺), impulses (B,
    k_t, 3)) — one launch of the step kernel on CUDA tensors.

    ``links`` and ``offsets`` (k, 3) place the feet; ``mu`` is a scalar,
    (k,) per foot, or (B,) or (B, k) per environment; ``ground_geoms`` (a
    :class:`.collision.Geoms` on links 0 … n−1) adds a contact for each
    endpoint sphere after the feet, with friction ``mu_ground`` (None:
    ``mu``); ``erp`` the share of a penetration recovered a step,
    ``margin`` the gap under which a contact is active, ``restitution``
    the bounce of the normal velocity; ``softness`` (scalar or (k_t,)) a
    compliance on each contact's rows; ``effort`` (nv,) clamps τ first;
    ``limits`` = (lo, hi) (nq,) — ±inf on ball and free slots — projects
    q⁺ and q̇⁺ onto the hinge ranges (``limit_mode="project"``). ``impl``:
    ``"auto"``, or ``"cuda"`` (CUDA tensors only). ``terrain``,
    impulse-mode limits, the loop, weld, tendon and joint-friction rows,
    implicit differentiation, ``relax`` ≠ 1 and ``impl="vmap"`` raise
    ``NotImplementedError``."""
    if limit_mode not in ("project", "impulse"):
        raise ValueError(f"limit_mode must be 'project' or 'impulse', "
                         f"got {limit_mode!r}")
    if diff_mode not in ("unroll", "implicit"):
        raise ValueError(f"diff_mode must be 'unroll' or 'implicit', "
                         f"got {diff_mode!r}")
    for name, value in dict(terrain=terrain, loops=loops, welds=welds,
                            tendons=tendons,
                            frictionloss=frictionloss).items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported for the multi-dof step yet: "
                f"{_KIN_CONTACT}")
    if limits is not None and limit_mode == "impulse":
        raise NotImplementedError(
            f"limit_mode='impulse' is not ported yet: {_KIN_CONTACT}")
    if diff_mode == "implicit":
        raise NotImplementedError(
            f"diff_mode='implicit' is not ported yet: {_KIN_CONTACT}")
    if relax != 1.0:
        raise NotImplementedError(
            f"relax != 1 is not ported yet: {_KIN_CONTACT}")
    _check_contacts(model.n, links, offsets)
    if ground_geoms is not None:
        _geom_links_ok(ground_geoms, 0, model.n, "md ground-geom")
    if limits is not None:
        _md_check_limits(model, limits[0], limits[1])
    _check_md_states(model, (q, qd, tau), ("q", "qd", "tau"))
    _check_impl(impl, q)
    if q.dim() != 2:
        raise ValueError(f"the batched stepper takes (B, nq) states, got q "
                         f"of shape {tuple(q.shape)}")
    if effort is not None:
        tau = clamp_effort(tau, effort)
    links = tuple(int(l) for l in links)
    B, k = q.shape[0], len(links)
    static = _cf.ground_geoms_static(ground_geoms)
    kt = k + len(static)
    q2, v2, imp = _mcf.md_step_ground_fused(
        model, _cols(q), _cols(qd), _cols(tau),
        _contact_mu(mu, mu_ground, k, static, B, q.dtype, q.device), dt,
        links, np.asarray(torch.as_tensor(offsets, dtype=torch.float64)),
        ground_z, gravity, iters, erp, margin, restitution,
        ground_geoms=ground_geoms, softness=softness)
    out_q, out_v = _unflat(q2, (B,)), _unflat(v2, (B,))
    if limits is not None:
        out_q, out_v = md_project_joint_limits(model, out_q, out_v,
                                               limits[0], limits[1])
    return (out_q, out_v), _unflat(imp, (B,)).reshape(B, kt, 3)
