"""The multi-dof frictional ground step and its plain version, in
batch-last PyTorch.

The port's counterpart of ``gridcodegenerator_tpu/ops/kernels/
md_contact_fused.py``: one velocity step of B ball-hip / free-joint robots
(q with quaternions, nq ≠ nv) on the flat ground — transforms, the
generalized RNEA bias, the CRBA mass matrix and its factor, world FK of the
contact links, the contacts' rows over the tangent coordinates
(:func:`_md_point_cols_s`), one merged solve M⁻¹[Jᵀ | τ − c], the Delassus
rows, the PGS cone solve and the retraction of ``md_tangent_apply``. It is
composed from the multi-dof bodies of :mod:`..md_blops` and the solve and
PGS helpers of :mod:`.contact_fused`.

Contacts are the feet (points of their links) and then the endpoint spheres
of ground geoms on regular links (the multi-dof stack has no base link: a
floating robot's torso is its first joint's link). There is no separate
base state, so every column comes from :func:`_md_point_cols_s`.

:func:`md_step_ground_fused` runs :func:`md_step_ground_plain` on CPU
tensors and the CUDA kernel (``csrc/md_step.cu``, built per topology and
set of contact links at first use) on CUDA tensors, with no fallback from
one to the other. The JAX package's VMEM gate (``md_step_workset_ok``) and
its XLA fallback fit a TPU tile; here one thread holds one state at every
size, so every robot runs the kernel.
"""

from __future__ import annotations

import torch

from ..md_blops import md_crba_bl, md_rnea_bl, md_transforms_bl
from ._launch import check_md_step, empty, launch, on_cpu, ptr
from .contact_fused import (_chol_apply_e, _chol_factor_ev, _cross3s,
                            _device_geom, _fk_s, _geom_copy, _jt_stacks,
                            _mv3s, _mv3s_c, _pgs_rows, _quat_exp_s,
                            _quat_mul_s, _quat_rot_s, _ridge, _sum_terms,
                            _support, device_geoms, geom_links,
                            ground_geoms_static)


def _md_point_cols_s(model, Rs, ps, link, x):
    """World q̇-columns of a point x (3,B) attached to ``link`` (JAX
    ``_md_point_cols_s``, :48): {tangent index: (3,B)} over the support's
    coordinates — each joint's (6, w) motion subspace gives w columns
    a_ω × (x − p_j) + a_v, the subspace's entries folded as constants and
    its zero halves skipped."""
    support = set(model.topology.ancestors[link]) | {link}
    cols = {}
    for j in sorted(support):
        sv, w = model.v_slices[j]
        S = model.S_np[j]
        for c in range(w):
            ang = [float(v) for v in S[:3, c]]
            lin = [float(v) for v in S[3:, c]]
            terms = []
            if any(ang):
                terms.append(_cross3s(_mv3s_c(Rs[j], ang), x - ps[j]))
            if any(lin):
                terms.append(_mv3s_c(Rs[j], lin))
            cols[sv + c] = _sum_terms(terms)
    return cols


def _normalized(quat):
    return quat / torch.sqrt(quat[0:1] * quat[0:1] + quat[1:2] * quat[1:2]
                             + quat[2:3] * quat[2:3] + quat[3:4] * quat[3:4])


def md_step_ground_plain(model, q, qd, tau, mu, dt, links, offsets,
                         ground_z=0.0, gravity=-9.81, iters=30, erp=0.2,
                         margin=1e-3, restitution=0.0, ground_static=(),
                         softness=None):
    """One multi-dof frictional ground step (JAX ``_md_step_ground_body``,
    :71): v_free = q̇ + dt·M⁻¹(τ − c); the rows J of the k feet (the points
    ``offsets`` (k, 3) of ``links``, gap = x_z − ground_z) and then of the
    endpoint spheres ``ground_static`` (link, centre, radius; gap = x_z −
    ground_z − r, the rows at the material point x − r·e_z); the Delassus G
    = J·M⁻¹Jᵀ (its lower triangle, read both ways) and b = J·v_free less
    v* = −erp·min(gap, 0)/dt − restitution·min(vn, 0) on the normal rows;
    ``iters`` PGS sweeps with the ridge 1e-9 (+ ``softness``, scalar or
    (k_t,)); v⁺ = v_free + M⁻¹Jᵀ·p; q⁺ = q ⊕ dt·v⁺ — a free joint's position
    by its pre-update attitude, then quaternions by quat ⊗ exp(½·dt·ω),
    renormalised, hinges and slides by dt·v. q (nq,B), q̇ and τ (nv,B), mu
    (k_t,B), the feet's rows then the geoms' → (q⁺ (nq,B), v⁺ (nv,B), p
    (3k_t,B))."""
    links = tuple(int(l) for l in links)
    ground_static = tuple(ground_static)
    nv = model.nv
    X = md_transforms_bl(model, q)
    c, *_ = md_rnea_bl(model, X, qd, None, gravity)
    Lm = _chol_factor_ev(md_crba_bl(model, X), nv)
    rhs_free = [tau[r:r + 1] - c[r:r + 1] for r in range(nv)]
    v = [qd[r:r + 1] for r in range(nv)]

    # the contacts: foot points (no radius), then geom endpoint spheres
    contacts = ([(l, [float(x) for x in offsets[i]], None)
                 for i, l in enumerate(links)]
                + [(l, list(e), r) for l, e, r in ground_static])
    Rs, ps = _fk_s(model, X, _support(model.topology,
                                      [ct[0] for ct in contacts]))
    kt = len(contacts)
    k3 = 3 * kt
    J, gaps, active = [], [], []
    for l, e, r in contacts:
        x = ps[l] + _mv3s_c(Rs[l], e)
        gap = x[2:3] - ground_z
        if r is not None:
            gap = gap - r
            # the material point at the surface: the world normal is e_z
            x = torch.cat([x[0:2], x[2:3] - r])
        cols = _md_point_cols_s(model, Rs, ps, l, x)
        for rr in range(3):
            row = [None] * nv
            for vi, col in cols.items():
                row[vi] = col[rr:rr + 1]
            J.append(row)
        gaps.append(gap)
        active.append((gap < margin).to(q.dtype))
    JT = _jt_stacks(J, nv, q[0:1])

    # one merged solve: rows 0..3k−1 M⁻¹Jᵀ, row 3k the free acceleration
    zero3k = torch.zeros((k3, q.shape[-1]), dtype=q.dtype, device=q.device)
    sol = _chol_apply_e(Lm, [torch.cat([zero3k if JT[c] is None else JT[c],
                                        rhs_free[c]]) for c in range(nv)])
    MiJt = [sol[c][:k3] for c in range(nv)]
    v_free = [v[c] + dt * sol[c][k3:] for c in range(nv)]

    def row_dot(r, x):
        return _sum_terms([J[r][c] * x[c] for c in range(nv)
                           if J[r][c] is not None])
    G_low = [_sum_terms([J[r][c] * MiJt[c][:r + 1] for c in range(nv)
                         if J[r][c] is not None]) for r in range(k3)]
    G = [[G_low[max(r, s)][min(r, s):min(r, s) + 1] for s in range(k3)]
         for r in range(k3)]
    b = [row_dot(r, v_free) for r in range(k3)]
    for ci, gap in enumerate(gaps):
        v_star = -erp * torch.clamp(gap, max=0.0) / dt
        if restitution:
            vn_now = row_dot(3 * ci + 2, v)
            v_star = v_star - restitution * torch.clamp(vn_now, max=0.0)
        b[3 * ci + 2] = b[3 * ci + 2] - v_star
    p = _pgs_rows(G, b, mu, active, kt, int(iters), _ridge(softness, kt))

    v_new = [v_free[c] + _sum_terms([MiJt[c][s:s + 1] * p[s:s + 1]
                                     for s in range(k3)]) for c in range(nv)]

    # the retraction (md_tangent_apply; a free joint's position by the
    # pre-update attitude)
    parts = []
    for i, t in enumerate(model.joint_types):
        s, _ = model.q_slices[i]
        sv, _ = model.v_slices[i]
        if t in ("floating", "spherical"):
            quat = q[s:s + 4]
            dphi = torch.cat([dt * v_new[sv + c] for c in range(3)])
            parts.append(_normalized(_quat_mul_s(quat, _quat_exp_s(dphi))))
            if t == "floating":
                dpos = torch.cat([dt * v_new[sv + 3 + c] for c in range(3)])
                parts.append(q[s + 4:s + 7] + _mv3s(_quat_rot_s(quat), dpos))
        else:
            parts.append(q[s:s + 1] + dt * v_new[sv])
    return torch.cat(parts), torch.cat(v_new), p


def md_step_ground_fused(model, q, qd, tau, mu, dt, links, offsets,
                         ground_z=0.0, gravity=-9.81, iters=30, erp=0.2,
                         margin=1e-3, restitution=0.0, ground_geoms=None,
                         softness=None):
    """One multi-dof frictional ground step for the feet ``links``
    (link-frame ``offsets`` (k, 3)) and the endpoint spheres of
    ``ground_geoms`` (a :class:`..collision.Geoms` on links 0 … n−1):
    batch-last q (nq,B), q̇ and τ (nv,B), ``mu`` (k_t,B) — the feet's rows,
    then the geoms' —, ``softness`` a scalar or (k_t,) → (q⁺ (nq,B), v⁺
    (nv,B), impulses (3k_t,B)). The kernel is built per topology and set of
    contact links; the offsets, the geom spheres and the ridge are device
    copies kept a set of values, everything else a run-time argument."""
    links = tuple(int(l) for l in links)
    static = ground_geoms_static(ground_geoms)
    if on_cpu(q):
        return md_step_ground_plain(model, q, qd, tau, mu, dt, links,
                                    offsets, ground_z, gravity, iters, erp,
                                    margin, restitution, static, softness)
    k = len(links)
    kt = k + len(static)
    B = check_md_step(model, q, qd, tau, mu, kt)
    outs = (empty(model, model.nq, B), empty(model, model.nv, B),
            empty(model, 3 * kt, B))
    if B:
        dev = torch.device(model.device)
        ridge = _geom_copy(_ridge(softness, kt), model.dtype, dev)
        launch("md_step_ground", "grid_md_step_ground", model,
               (q.data_ptr(), qd.data_ptr(), tau.data_ptr(), mu.data_ptr(),
                _device_geom(model, offsets, k).data_ptr(),
                ptr(device_geoms(static, model.dtype, dev)),
                ridge.data_ptr(), *(o.data_ptr() for o in outs)), B, k,
               float(dt), float(ground_z), float(gravity), int(iters),
               float(erp), float(margin), float(restitution),
               links=links + geom_links(static))
    return outs
