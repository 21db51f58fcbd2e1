"""Capsule and sphere geoms, their contacts, and the collision rows of the
free-flyer stepper.

The port's counterpart of ``gridcodegenerator_tpu/ops/collision.py``'s
data half (:40-162, :359-382) — the geom, obstacle and collision-model
types, their builders, the self-collision candidate pairs, and the
ground-contact list that the ground steppers read (one contact per sphere,
two per capsule: each endpoint sphere touches the ground on its own) — and
of its batch-last collision rows (:439-573): the clamped segment–segment
closest points (:func:`_seg_seg_closest_bl`), a pair's gap, normal and
contact point (:func:`_pair_geometry_bl`), the branchless contact frame
(:func:`_contact_frame_cols_bl`), a traced point's joint columns
(:func:`_arm_point_jac_bl`), the geoms' segments (:func:`_geom_segments_bl`)
and :func:`fb_collision_rows_bl` / :func:`fb_collision_distances`. The
stepper's plain version (``kernels/contact_fused._collision_rows_s``) builds
its rows from these same helpers, so the two share one copy. One primitive
serves every shape: the capsule, a segment [a, b] in a link's frame with
radius r; a sphere is a == b.

A geom set is concrete geometry here: its tensors hold numbers the steppers
read once a set (the kernels take the endpoints and radii as run-time
arguments; :func:`make_geoms` and :func:`make_collision_model` keep the
static lists on the set). The JAX package's traced branch of the
ground-contact list (two contacts for any traced geom) has no counterpart.
The single-state queries (``collision_rows``, ``collision_distances``,
``fb_collision_rows``, ``fb_ground_geom_rows``) wait for the single-state
kinematics of ROADMAP Queue 1, 'The rest of kinematics and contact'.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.robot import _require_device


class Geoms(NamedTuple):
    """Capsule geoms attached to robot links (spheres: ``a == b``).

    ``links[i] == -1`` attaches geom i to the floating base of a free flyer
    (the MuJoCo quadruped-torso pattern): its endpoints are base-frame
    constants and its joint columns are zero. The multi-dof stack has no
    base link: a floating robot's torso is its first joint's link there.

    ``ground`` is the set's static ground-contact list, which the ground
    steppers read (:func:`ground_contacts`): :func:`make_geoms` builds it
    once from the values it stores, so a loop of steps reads no tensor back
    to the host; a set built otherwise (None) has it made at each step.
    The steppers read ``ground``, not the tensors: to change the geometry,
    make a new set with :func:`make_geoms`."""
    links: Tuple[int, ...]     # owning link per geom (-1 = base)
    a: torch.Tensor            # (g, 3) segment start, link frame
    b: torch.Tensor            # (g, 3) segment end, link frame
    r: torch.Tensor            # (g,)  radii
    ground: Optional[tuple] = None   # ground_contacts(self), or None


class Obstacles(NamedTuple):
    """Static world-frame capsule/sphere obstacles."""
    a: torch.Tensor            # (w, 3)
    b: torch.Tensor            # (w, 3)
    r: torch.Tensor            # (w,)


class CollisionModel(NamedTuple):
    """Candidate-pair collision set: ``pairs`` geom-geom self-collision
    candidates (indices into ``geoms``), ``obs_pairs`` (geom, obstacle)
    candidates. Build with :func:`make_collision_model`, which defaults
    ``obs_pairs`` to the full cross product and ``pairs`` to non-adjacent
    link pairs, and keeps the set's static form (:func:`collision_static`)
    in ``static``, so a loop of steps reads no tensor back to the host; a
    set built otherwise (None) has it made at each step."""
    geoms: Geoms
    pairs: Tuple[Tuple[int, int], ...]
    obstacles: Optional[Obstacles]
    obs_pairs: Tuple[Tuple[int, int], ...]
    static: Optional[tuple] = None   # collision_static(self), or None

    @property
    def n_contacts(self) -> int:
        return len(self.pairs) + len(self.obs_pairs)


def _tensor(x, dtype, device):
    return (x.to(dtype=dtype, device=device) if isinstance(x, torch.Tensor)
            else torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                              device=device))


def make_geoms(links, a, b=None, r=0.05, dtype=torch.float32,
               device="cuda") -> Geoms:
    """Geoms on ``device`` (the card unless the caller names another) in
    ``dtype``; ``b=None`` makes every geom a sphere at ``a``."""
    device = _require_device(device)
    g = len(links)
    a = _tensor(a, dtype, device).reshape(g, 3)
    b = a if b is None else _tensor(b, dtype, device).reshape(g, 3)
    r = torch.broadcast_to(_tensor(r, dtype, device), (g,)).contiguous()
    geoms = Geoms(tuple(int(l) for l in links), a, b, r)
    return geoms._replace(ground=ground_contacts(geoms))


def make_obstacles(a, b=None, r=0.05, dtype=torch.float32,
                   device="cuda") -> Obstacles:
    device = _require_device(device)
    a = torch.atleast_2d(_tensor(a, dtype, device))
    b = a if b is None else torch.atleast_2d(_tensor(b, dtype, device))
    r = torch.broadcast_to(_tensor(r, dtype, device),
                           (a.shape[0],)).contiguous()
    return Obstacles(a, b, r)


def auto_pairs(topology, geoms: Geoms, min_separation: int = 2):
    """Self-collision candidates: geom pairs whose links are at least
    ``min_separation`` apart along the kinematic tree (adjacent links
    mechanically overlap at the joint). The base (link -1) sits one joint
    above every root link: dist(base, j) = depth(j) + 1."""
    n = topology.n
    anc = [set(topology.ancestors[i]) | {i} for i in range(n)]

    def tree_dist(i, j):
        if i == -1 or j == -1:
            k = j if i == -1 else i
            return len(anc[k])          # = depth(k) + 1
        common = anc[i] & anc[j]
        depth = lambda s: max(len(anc[k]) for k in s) if s else 0
        return (len(anc[i]) - depth(common)) + (len(anc[j]) - depth(common))

    out = []
    for gi in range(len(geoms.links)):
        for gj in range(gi + 1, len(geoms.links)):
            li, lj = geoms.links[gi], geoms.links[gj]
            if li == lj:
                continue
            if tree_dist(li, lj) >= min_separation:
                out.append((gi, gj))
    return tuple(out)


def make_collision_model(geoms: Geoms, topology=None, pairs=None,
                         obstacles: Optional[Obstacles] = None,
                         obs_pairs=None,
                         min_separation: int = 2) -> CollisionModel:
    if pairs is None:
        pairs = (auto_pairs(topology, geoms, min_separation)
                 if topology is not None else ())
    if obstacles is None:
        obs_pairs = ()
    elif obs_pairs is None:
        obs_pairs = tuple((g, w) for g in range(len(geoms.links))
                          for w in range(obstacles.a.shape[0]))
    cm = CollisionModel(geoms, tuple(pairs), obstacles, tuple(obs_pairs))
    if not _pairs_in_range(cm):
        return cm                # _check_geoms names the bad pair at a step
    from .kernels.contact_fused import collision_static

    return cm._replace(static=collision_static(cm))


def _pairs_in_range(cm: CollisionModel) -> bool:
    g = len(cm.geoms.links)
    w = 0 if cm.obstacles is None else cm.obstacles.a.shape[0]
    return (all(0 <= i < g and 0 <= j < g for i, j in cm.pairs)
            and all(0 <= i < g and 0 <= o < w for i, o in cm.obs_pairs))


def _check_geoms(n_links: int, cm: CollisionModel, allow_base: bool = True):
    """Fail fast on malformed collision sets: geom links in range, pair
    indices valid. ``allow_base``: accept link -1 (floating-base geoms),
    as the free-flyer entry points do."""
    g = len(cm.geoms.links)
    lo = -1 if allow_base else 0
    bad = [l for l in cm.geoms.links if not lo <= l < n_links]
    if bad:
        hint = ("" if allow_base else
                " (link -1 = base geoms are free-flyer-only; for a fixed "
                "base express them as obstacles)")
        raise ValueError(f"collision geom links {bad} out of range "
                         f"[{lo}, {n_links}){hint}")
    for gi, gj in cm.pairs:
        if not (0 <= gi < g and 0 <= gj < g):
            raise ValueError(f"self-collision pair ({gi}, {gj}) out of "
                             f"range for {g} geoms")
    w = 0 if cm.obstacles is None else cm.obstacles.a.shape[0]
    for gi, wi in cm.obs_pairs:
        if not (0 <= gi < g and 0 <= wi < w):
            raise ValueError(f"obstacle pair ({gi}, {wi}) out of range "
                             f"({g} geoms, {w} obstacles)")


def _numpy(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _ground_contact_list(geoms: Geoms):
    """Static (geom_idx, endpoint_idx ∈ {0, 1}) list, one per ground
    contact: endpoint 0 of every geom, and endpoint 1 of a capsule (a geom
    whose endpoints differ)."""
    an, bn = _numpy(geoms.a), _numpy(geoms.b)
    out = []
    for i in range(len(geoms.links)):
        out.append((i, 0))
        if not np.allclose(an[i], bn[i]):
            out.append((i, 1))
    return tuple(out)


def n_ground_contacts(geoms: Geoms) -> int:
    """Ground-contact count of a geom set: 2 per capsule, 1 per sphere."""
    return len(_ground_contact_list(geoms))


def ground_contacts(geoms: Geoms) -> tuple:
    """The static ground-contact list of ``geoms`` (JAX
    ``ground_geoms_static``, contact_fused.py:783): (link, endpoint (3
    floats), radius) a contact, one per sphere and two per capsule
    (:func:`_ground_contact_list`), in the order the steppers' rows and
    impulses follow."""
    a, b, r = (_numpy(x).astype(float) for x in (geoms.a, geoms.b, geoms.r))
    return tuple(
        (int(geoms.links[i]),
         tuple(float(v) for v in (a[i] if e == 0 else b[i])), float(r[i]))
        for i, e in _ground_contact_list(geoms))


# ------------------------------------------------ batch-last (the stepper)
# Geometry per vector component with the environment batch last: (3, B)
# vectors, (1, B) scalars, every sum left to right — the order the step
# kernel (csrc/contact.cuh) keeps.
_EPS = 1e-12


def _dot(x, y):
    """Σ_c x_c·y_c of (3,B) vectors, left to right → (1,B)."""
    return x[0:1] * y[0:1] + x[1:2] * y[1:2] + x[2:3] * y[2:3]


def _seg_seg_closest_bl(p1, d1, p2, d2):
    """Segment (start (3,B), vector (3,B)) pairs → their closest points
    ((3,B), (3,B)): the clamped Ericson algebra, the two denominators
    regularised by ``_EPS`` (degenerate segments, spheres, included)."""
    rv = p1 - p2
    a, e, b = _dot(d1, d1), _dot(d2, d2), _dot(d1, d2)
    c, f = _dot(d1, rv), _dot(d2, rv)
    denom = a * e - b * b
    zero = torch.zeros_like(denom)
    s = torch.clamp(torch.where(denom > _EPS, (b * f - c * e)
                                / torch.clamp(denom, min=_EPS), zero),
                    0.0, 1.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=_EPS), 0.0, 1.0)
    s = torch.clamp((b * t - c) / torch.clamp(a, min=_EPS), 0.0, 1.0)
    return p1 + s * d1, p2 + t * d2


def _contact_frame_cols_bl(nr):
    """Unit normals (3,B) → the frame rows (t1, t2, n), each (3,B): the
    branchless basis (sign = ±1 by n_z ≥ 0). At n_z = 0 the basis flips
    with one ulp of n_z; the cone is isotropic, so the physics does not."""
    n0, n1, n2 = nr[0:1], nr[1:2], nr[2:3]
    up = n2 >= 0.0
    one = torch.ones_like(n2)
    sign = torch.where(up, one, -one)
    aa = -1.0 / (sign + n2 + torch.where(up, one * _EPS, -one * _EPS))
    bb = n0 * n1 * aa
    t1 = torch.cat([1.0 + sign * n0 * n0 * aa, sign * bb, -sign * n0])
    t2 = torch.cat([bb, sign + n1 * n1 * aa, -n1])
    return t1, t2, nr


def _pair_geometry_bl(cA, dA, rA, cB, dB, rB):
    """Two capsules (start, vector (3,B) each; radii floats) → gap (1,B),
    unit normal B→A (3,B) and the shared contact point (3,B), the
    midpoint of the two surface points."""
    wA, wB = _seg_seg_closest_bl(cA, dA, cB, dB)
    diff = wA - wB
    dist = torch.sqrt(_dot(diff, diff) + _EPS)
    nrm = diff / dist
    gap = dist - rA - rB
    point = 0.5 * ((wA - rA * nrm) + (wB + rB * nrm))
    return gap, nrm, point


def _arm_point_jac_bl(ffm, Rs, ps, link, x):
    """The joint columns, in base coordinates, of a point x (3,B) rigidly
    attached to ``link``: {j: a_ang × (x − p_j) + a_lin} over ancestors(link)
    ∪ {link}, ascending, with a = Rs[j]·S_j; {} for the base (link −1).
    Rs, ps: the links' poses (``kernels/contact_fused._fk_s``)."""
    if link < 0:
        return {}
    from .kernels.contact_fused import _cross3s, _mv3s

    S = ffm.arm.S[..., None]
    return {j: _cross3s(_mv3s(Rs[j], S[j][:3]), x - ps[j])
            + _mv3s(Rs[j], S[j][3:])
            for j in sorted(set(ffm.arm.topology.ancestors[link]) | {link})}


def _geom_segments_bl(static, Rs, ps, like):
    """Each geom's segment in base coordinates, (start (3,B), vector
    (3,B)), from ``static``'s geoms ((link, a (3 floats), b − a, r) each):
    on a link ps + Rs·a and Rs·(b − a), on the base the constants."""
    from .kernels.contact_fused import _mv3s_c

    one = like[0:1] * 0.0 + 1.0
    out = []
    for l, a, d, _ in static.geoms:
        if l < 0:
            out.append((torch.cat([one * c for c in a]),
                        torch.cat([one * c for c in d])))
        else:
            out.append((ps[l] + _mv3s_c(Rs[l], a), _mv3s_c(Rs[l], d)))
    return out


def fb_collision_rows_bl(ffm, quat_bl, pos_bl, q_bl, cm: CollisionModel):
    """The collision contacts of a free flyer, batch last: quat (4,B), pos
    (3,B), q (n,B) → (gaps (c,B), J (3c, 6+n, B)), each contact's [t1, t2,
    n] rows over [ω_b; v_b; q̇] (n from the second geom, or the obstacle,
    toward the first), the self pairs first, then the obstacle pairs —
    appendable to the stepper's foot rows. A self pair has no base
    columns (the relative velocity of coincident points is
    base-invariant); an obstacle pair has the full base block."""
    from .kernels import contact_fused as cf

    _check_geoms(ffm.n, cm)
    cs = cf.collision_static(cm)
    if cs is None:                              # no candidate pairs
        return (q_bl.new_zeros((0, q_bl.shape[-1])),
                q_bl.new_zeros((0, 6 + ffm.n, q_bl.shape[-1])))
    X = cf.blops.joint_transforms_bl(ffm.arm, q_bl)
    R = cf._quat_rot_s(quat_bl)
    rows, gaps = cf._collision_rows_s(ffm, X, R, pos_bl, cs)
    return torch.cat(gaps), cf._dense_rows(rows, 6 + ffm.n, q_bl[0:1])


def fb_collision_distances(ffm, quat_bl, pos_bl, q_bl, cm: CollisionModel):
    """The collision contacts' gaps (c,B) — surface distance, negative in
    penetration — of :func:`fb_collision_rows_bl`."""
    return fb_collision_rows_bl(ffm, quat_bl, pos_bl, q_bl, cm)[0]
