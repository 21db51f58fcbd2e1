"""Contact dynamics of a free flyer, batched: the stance FD and the
frictional ground step.

The port's counterpart of ``gridcodegenerator_tpu/ops/contact.py``'s
stance FD: k points of the robot pinned to world anchors (stance feet),

    M·[v̇b; q̈] = [−f_b; τ − c_j] + Jᵀλ,    J·[v̇b; q̈] + J̇·[vb; q̇] = a*,

solved by elimination through the Delassus operator G = J·M⁻¹·Jᵀ, with
the Baumgarte acceleration a* = −2α·J·[vb; q̇] − β²·(x − anchor).
:func:`fb_constrained_fd_batched` runs the stance kernel
(``stance_fd_fused``, :mod:`.kernels.contact_fused`) on CUDA tensors and
its plain version on CPU tensors. The JAX package's second batch-last
pipeline of the same function (``_fb_bias_bl``, ``_fb_mass_matrix_bl``,
``chol_*_bl``, ``_fb_contact_rows_bl``) is not copied: the tests hold the
port to it directly.

The ground step (:func:`fb_step_ground_batched`, and T of them in
:func:`fb_simulate_ground_batched`) advances B frictional environments —
the parallel-RL shape — by one velocity step: the unilateral contacts of
the feet, of self-collision and obstacle pairs and of ground geoms'
endpoint spheres (:mod:`.collision`) with the flat ground or a heightfield
(:mod:`.terrain`) and with each other, the bilateral rows of loop closures
(:mod:`.loops`), a projected Gauss–Seidel solve of the friction cones and
the closures on the Delassus operator, and semi-implicit integration on the
quaternion manifold. It runs the step kernels of
:mod:`.kernels.contact_fused` on CUDA tensors and their plain version on
CPU tensors. The weld, tendon and joint-friction rows, impulse-mode limits,
implicit differentiation and ``relax`` ≠ 1 raise ``NotImplementedError``
naming their ROADMAP item; so do the fixed-base pins and the single-state
functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import _check_impl, _cols, _unflat
from .collision import _check_geoms
from .freeflyer import FreeFlyerModel, _check_ff_states
from .kernels import contact_fused as _cf
from .loops import _check_fb_pairs

# ROADMAP items are named by title, which a renumbering leaves as it is
_KIN_CONTACT = "ROADMAP Queue 1, 'The rest of kinematics and contact'"


def _check_contacts(n_links_valid, links, offsets):
    """Fail fast on malformed contact geometry: a non-empty tuple of links
    within range, and offsets shaped (k, 3)."""
    links = tuple(links)
    if not links:
        raise ValueError("contact set is empty: pass at least one link")
    for l in links:
        if not (0 <= int(l) < n_links_valid):
            raise ValueError(
                f"contact link index {l} out of range [0, {n_links_valid})")
    shp = np.shape(offsets)
    if shp != (len(links), 3):
        raise ValueError(
            f"offsets must be ({len(links)}, 3) body-frame points, got {shp}")


def fb_constrained_fd_batched(ffm: FreeFlyerModel, quat, pos, q, vb, qd, tau,
                              links, offsets, anchors=None, gravity=-9.81,
                              baumgarte=(0.0, 0.0), reg=0.0, impl="auto"):
    """Stance FD over leading batch axes: quat (..., 4), pos (..., 3), q,
    q̇, τ (..., n), vb (..., 6) → (v̇b (..., 6), q̈ (..., n), λ (..., 3k)).

    ``links`` (k link indices) and ``offsets`` (k, 3) place the contact
    points in their links' frames; ``anchors`` (k, 3) are the world pins
    (None: each point's current position, a pure velocity constraint);
    ``baumgarte`` = (α, β); ``reg`` is a ridge on the Delassus operator for
    redundant contact sets. λ is the world-frame force on the robot at each
    point. ``impl``: ``"auto"``, or ``"cuda"`` (CUDA tensors only)."""
    _check_contacts(ffm.n, links, offsets)
    names = ("quat", "pos", "q", "vb", "qd", "tau")
    states = (quat, pos, q, vb, qd, tau)
    _check_ff_states(ffm, states, names)
    _check_impl(impl, q)
    dvb, qdd, lam = _cf.stance_fd_fused(
        ffm, *(_cols(x) for x in states), links,
        np.asarray(offsets, np.float64),
        None if anchors is None else np.asarray(anchors, np.float64),
        gravity, baumgarte, reg)
    batch = tuple(q.shape[:-1])
    return _unflat(dvb, batch), _unflat(qdd, batch), _unflat(lam, batch)


# --------------------------------------------------------------------------
# step helpers
# --------------------------------------------------------------------------
def joint_limit_torque(q, qd, lo, hi, kp=200.0, kd=5.0):
    """Soft joint-limit torque (a spring-damper, zero inside [lo, hi]):
    kp·(lo − q)⁺ − kp·(q − hi)⁺, and −kd·q̇ while a joint is past a bound
    and moving further out. A penalty for reward shaping or compliant
    models; the hard limits are the steppers' ``limits=`` projection.
    Elementwise over any shape that broadcasts with (lo, hi)."""
    lo = torch.as_tensor(lo, dtype=q.dtype, device=q.device)
    hi = torch.as_tensor(hi, dtype=q.dtype, device=q.device)
    over = torch.clamp(q - hi, min=0.0)
    under = torch.clamp(lo - q, min=0.0)
    outward = ((over > 0) & (qd > 0)) | ((under > 0) & (qd < 0))
    return kp * (under - over) - kd * qd * outward.to(q.dtype)


def pd_torque(q, qd, q_target, kp, kd, qd_target=0.0):
    """The joint-space PD servo kp·(q* − q) − kd·(q̇ − q̇*), elementwise:
    the usual RL action map (actions as position targets)."""
    return kp * (q_target - q) - kd * (qd - qd_target)


def clamp_effort(tau, effort):
    """Actuator saturation: τ clamped to ±effort (``inf`` entries leave
    their joint free)."""
    e = torch.as_tensor(effort, dtype=tau.dtype, device=tau.device)
    return torch.clamp(tau, -e, e)


def project_joint_limits(q, qd, lo, hi):
    """Hard joint limits as a position-level projection: q clamped into
    [lo, hi], and the outward velocity of a joint at a bound set to 0.
    Applied to the integrator's outputs; the stopping impulse is not
    passed on to the base within the step."""
    lo = torch.as_tensor(lo, dtype=q.dtype, device=q.device)
    hi = torch.as_tensor(hi, dtype=q.dtype, device=q.device)
    stop = ((q >= hi) & (qd > 0)) | ((q <= lo) & (qd < 0))
    return torch.clamp(q, lo, hi), torch.where(stop, torch.zeros_like(qd),
                                               qd)


def soft_contact_params(kp, kd, dt):
    """A compliant contact's spring-damper (stiffness ``kp`` [N/m],
    damping ``kd`` [N·s/m]) as the stepper's ``(erp, softness)``: the
    implicit-Euler discretisation of F = −kp·x − kd·ẋ (the ODE ERP/CFM
    relation), erp = dt·kp/(dt·kp + kd) and softness = 1/(dt·(dt·kp +
    kd)), the compliance added to each cone row of the Delassus operator.
    softness → 0 is the rigid contact. Scalars or per-contact arrays."""
    denom = dt * kp + kd
    try:
        bad = bool(np.any(np.asarray(denom) <= 0.0))
    except (TypeError, RuntimeError, ValueError):
        bad = False        # a tensor that needs grad: the caller's to check
    if bad:
        raise ValueError(
            f"soft_contact_params: dt*kp + kd = {np.asarray(denom)} must "
            "be positive everywhere (kp and kd cannot both be "
            "zero/negative) — erp and softness would be inf/NaN")
    return dt * kp / denom, 1.0 / (dt * denom)


def _mu_to_bl(mu, k, B, dtype, device):
    """Friction coefficients as a batch-last (k, B) tensor from a scalar, a
    (k,) per-foot array or a (B,) / (B, k) per-environment one. A 1-D
    array is ambiguous when B == k, so that case must come as (B, k)."""
    if isinstance(mu, (int, float)):
        return torch.full((k, B), float(mu), dtype=dtype, device=device)
    mu_arr = torch.as_tensor(mu, dtype=dtype, device=device)
    if mu_arr.dim() == 2:                      # (B, k) → (k, B)
        return mu_arr.T.contiguous()
    if mu_arr.dim() == 1:
        if B == k and mu_arr.shape[0] == k:
            raise ValueError(
                f"mu with shape ({k},) is ambiguous when the batch size "
                f"equals the contact count (B == k == {k}): pass an "
                f"explicit (B, {k}) per-environment array or a scalar")
        if mu_arr.shape[0] == B and B != k:    # per-environment
            return mu_arr[None, :].expand(k, B).contiguous()
        return mu_arr[:, None].expand(k, B).contiguous()   # per-foot
    return mu_arr.expand(k, B).contiguous()


# --------------------------------------------------------------------------
# the ground step
# --------------------------------------------------------------------------
def _check_step_options(options, limits, limit_mode, diff_mode, relax):
    """Raise for an option whose rows or solver path are not ported:
    ``NotImplementedError`` naming its ROADMAP item; ``ValueError`` for a
    mode the JAX package does not know either."""
    if limit_mode not in ("project", "impulse"):
        raise ValueError(f"limit_mode must be 'project' or 'impulse', "
                         f"got {limit_mode!r}")
    if diff_mode not in ("unroll", "implicit"):
        raise ValueError(f"diff_mode must be 'unroll' or 'implicit', "
                         f"got {diff_mode!r}")
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet: {_KIN_CONTACT}")
    if limits is not None and limit_mode == "impulse":
        raise NotImplementedError(
            f"limit_mode='impulse' is not ported yet: {_KIN_CONTACT}")
    if diff_mode == "implicit":
        raise NotImplementedError(
            f"diff_mode='implicit' is not ported yet: {_KIN_CONTACT}")
    if relax != 1.0:
        raise NotImplementedError(
            f"relax != 1 is not ported yet: {_KIN_CONTACT}")


def _geom_links_ok(geoms, lo, n, what):
    """Raise the JAX package's error for a ground geom on a link outside
    [lo, n)."""
    bad = [l for l in geoms.links if not lo <= l < n]
    if bad:
        raise ValueError(f"{what} links {bad} out of range [{lo}, {n})"
                         + ("" if lo < 0 else
                            " — the multi-dof stack has no base link; "
                            "attach torso geoms to the floating joint's "
                            "link"))


def _contact_mu(mu, mu_ground, k, static, B, dtype, device, kc=0,
                mu_collision=None):
    """The friction coefficients of every cone row as one batch-last (k_t,
    B) tensor: the k feet's from ``mu`` (:func:`_mu_to_bl`), then the kc
    collision contacts' from ``mu_collision`` and the ground-geom contacts'
    (``static``) from ``mu_ground`` — each, where it is None, from ``mu``
    itself, per environment where ``mu`` is (the JAX XLA body's rule,
    contact.py:1775-1783)."""
    parts = [_mu_to_bl(mu, k, B, dtype, device)]
    for mu_x, kx, what, kw in ((mu_collision, kc, "collision contacts'",
                                "mu_collision"),
                               (mu_ground, len(static), "ground geoms'",
                                "mu_ground")):
        if not kx:
            continue
        part = _mu_to_bl(mu if mu_x is None else mu_x, kx, B, dtype, device)
        if tuple(part.shape) != (kx, B):
            raise ValueError(f"the {what} mu must broadcast to ({kx}, {B}), "
                             f"got {tuple(part.shape)}: pass {kw}")
        parts.append(part)
    return torch.cat(parts)


def _step_setup(ffm, links, offsets, collision, loops, ground_geoms, mu,
                mu_collision, mu_ground, B, q):
    """Check a step's contact sets (the JAX package's errors) and gather
    what every step of them reads: the feet's links, the k_t cone contacts'
    μ (k_t, B) and the count k_t."""
    _check_contacts(ffm.n, links, offsets)
    if collision is not None:
        _check_geoms(ffm.n, collision)
    if loops is not None:
        _check_fb_pairs(ffm.n, *loops)
    if ground_geoms is not None:
        _geom_links_ok(ground_geoms, -1, ffm.n, "ground-geom")
    links = tuple(int(l) for l in links)
    kc = 0 if collision is None else collision.n_contacts
    static = _cf.ground_geoms_static(ground_geoms)
    mu_bl = _contact_mu(mu, mu_ground, len(links), static, B, q.dtype,
                        q.device, kc, mu_collision)
    return links, mu_bl, len(links) + kc + len(static)


def _step_bl(ffm, s, tau, mu, push, dt, links, offsets, ground_z, terrain,
             limits, kw):
    """One step on batch-last states s = (quat, pos, q, vb, q̇) → (quat⁺,
    pos⁺, q⁺, vb⁺, q̇⁺, impulses (3k_t,B)), with the joint limits
    projected."""
    if terrain is None:
        out = _cf.step_ground_fused(ffm, *s, tau, mu, dt, links, offsets,
                                    ground_z, push=push, **kw)
    else:
        out = _cf.step_ground_terrain_fused(ffm, *s, tau, mu, dt, links,
                                            offsets, terrain, push=push, **kw)
    if limits is None:
        return out
    q2, qd2 = project_joint_limits(out[2], out[4],
                                   torch.as_tensor(limits[0])[:, None],
                                   torch.as_tensor(limits[1])[:, None])
    return out[:2] + (q2, out[3], qd2, out[5])


_STATE = ("quat", "pos", "q", "vb", "qd")


def _check_batch(ffm, state, tau=None):
    """(B, d) states and τ (B, n) if given, one batch B."""
    if tau is None:
        _check_ff_states(ffm, state, _STATE)
    else:
        _check_ff_states(ffm, (*state, tau), _STATE + ("tau",))
    if state[2].dim() != 2:
        raise ValueError(f"the batched stepper takes (B, d) states, got q "
                         f"of shape {tuple(state[2].shape)}")


def fb_step_ground_batched(ffm: FreeFlyerModel, state, tau, dt, links,
                           offsets, mu=0.8, ground_z=0.0, gravity=-9.81,
                           iters: int = 30, erp: float = 0.2,
                           margin: float = 1e-3, restitution: float = 0.0,
                           impl="auto", limits=None, effort=None,
                           limit_mode: str = "project",
                           diff_mode: str = "unroll", relax: float = 1.0,
                           terrain=None, collision=None, mu_collision=None,
                           ground_geoms=None, mu_ground=None, loops=None,
                           welds=None, f_base=None, frictionloss=None,
                           softness=None, tendons=None):
    """B frictional ground environments advanced by one step: ``state =
    (quat (B,4), pos (B,3), q (B,n), vb (B,6), qd (B,n))``, ``tau (B,n)`` →
    (next state, impulses (B,k_t,3)) — one launch of the step kernel on
    CUDA tensors.

    ``links`` and ``offsets`` (k, 3) place the feet; ``mu`` is a scalar,
    (k,) per foot, or (B,) or (B, k) per environment; ``terrain`` a
    :class:`.terrain.Terrain` in place of the plane ``z = ground_z``;
    ``erp`` the share of a penetration (and of a loop's gap) recovered a
    step, ``margin`` the gap under which a contact is active,
    ``restitution`` the bounce of the normal velocity. ``collision`` (a
    :class:`.collision.CollisionModel`) adds a cone contact for each self
    pair and each obstacle pair after the feet, with friction
    ``mu_collision`` (None: ``mu``); ``ground_geoms`` (a
    :class:`.collision.Geoms` on links −1 — the base — to n−1) one for each
    endpoint sphere (one a sphere, two a capsule) after those, with
    friction ``mu_ground`` (None: ``mu``); ``loops`` = (pairs, offsets_a,
    offsets_b) closes each (a, b) link pair — b = −1 pins a's point to the
    world anchor offsets_b — by three bilateral rows solved after the cones
    (no impulses returned for them). ``f_base`` (B,6) is an external base
    wrench; ``softness`` (scalar or (k_t,), see :func:`soft_contact_params`)
    a compliance on each cone contact's rows; ``effort`` (n,) clamps τ
    first; ``limits`` = (lo, hi) (n,) projects q⁺ and q̇⁺ onto the joint
    ranges (``limit_mode="project"``). ``impl``: ``"auto"``, or ``"cuda"``
    (CUDA tensors only). The weld, tendon and joint-friction rows,
    impulse-mode limits, implicit differentiation, ``relax`` ≠ 1 and
    ``impl="vmap"`` raise ``NotImplementedError``."""
    _check_step_options(
        dict(welds=welds, tendons=tendons, frictionloss=frictionloss),
        limits, limit_mode, diff_mode, relax)
    _check_batch(ffm, state, tau)
    q = state[2]
    B = q.shape[0]
    links, mu_bl, kt = _step_setup(ffm, links, offsets, collision, loops,
                                   ground_geoms, mu, mu_collision, mu_ground,
                                   B, q)
    _check_impl(impl, q)
    if effort is not None:
        tau = clamp_effort(tau, effort)
    if f_base is not None and tuple(f_base.shape) != (B, 6):
        raise ValueError(f"f_base must be ({B}, 6), got "
                         f"{tuple(f_base.shape)}")
    out = _step_bl(ffm, [_cols(x) for x in state], _cols(tau), mu_bl,
                   _cols(f_base), dt, links, offsets, ground_z, terrain,
                   limits,
                   dict(gravity=gravity, iters=iters, erp=erp, margin=margin,
                        restitution=restitution, softness=softness,
                        ground_geoms=ground_geoms, collision=collision,
                        loops=loops))
    nxt = tuple(_unflat(x, (B,)) for x in out[:5])
    return nxt, _unflat(out[5], (B,)).reshape(B, kt, 3)


def fb_simulate_ground_batched(ffm: FreeFlyerModel, state0, taus, dt, links,
                               offsets, mu=0.8, ground_z=0.0, gravity=-9.81,
                               iters: int = 30, erp: float = 0.2,
                               margin: float = 1e-3,
                               restitution: float = 0.0, impl="auto",
                               terrain=None, collision=None,
                               mu_collision=None, ground_geoms=None,
                               mu_ground=None, loops=None, f_bases=None):
    """T steps of :func:`fb_step_ground_batched`: ``state0`` as its state,
    ``taus`` (T, B, n), ``f_bases`` optional (T, B, 6) per-step base
    wrenches (push schedules), ``collision``, ``mu_collision``,
    ``ground_geoms``, ``mu_ground`` and ``loops`` as there → (final state,
    impulses (T, B, k_t, 3)). The states stay batch last between the steps
    (one layout change at each end), so the result equals T single
    steps."""
    _check_batch(ffm, state0)
    q = state0[2]
    if taus.dim() != 3 or tuple(taus.shape[1:]) != tuple(q.shape):
        raise ValueError(f"taus must be (T, {q.shape[0]}, {ffm.n}), got "
                         f"{tuple(taus.shape)}")
    T, B = taus.shape[0], q.shape[0]
    links, mu_bl, kt = _step_setup(ffm, links, offsets, collision, loops,
                                   ground_geoms, mu, mu_collision, mu_ground,
                                   B, q)
    _check_impl(impl, q)
    if f_bases is not None and tuple(f_bases.shape) != (T, B, 6):
        raise ValueError(f"f_bases must be ({T}, {B}, 6), got "
                         f"{tuple(f_bases.shape)}")
    s = [_cols(x) for x in state0]
    taus_bl = taus.permute(0, 2, 1).contiguous()              # (T, n, B)
    pushes = (None if f_bases is None
              else f_bases.permute(0, 2, 1).contiguous())    # (T, 6, B)
    kw = dict(gravity=gravity, iters=iters, erp=erp, margin=margin,
              restitution=restitution, ground_geoms=ground_geoms,
              collision=collision, loops=loops)
    imps = torch.empty((T, 3 * kt, B), dtype=q.dtype, device=q.device)
    for t in range(T):
        *s, imps[t] = _step_bl(ffm, s, taus_bl[t], mu_bl,
                               None if pushes is None else pushes[t], dt,
                               links, offsets, ground_z, terrain, None, kw)
    final = tuple(_unflat(x, (B,)) for x in s)
    return final, imps.permute(0, 2, 1).reshape(T, B, kt, 3)
