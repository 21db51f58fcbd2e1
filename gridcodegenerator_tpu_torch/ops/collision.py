"""Capsule and sphere geoms, and the static lists of their contacts.

The port's counterpart of the data half of
``gridcodegenerator_tpu/ops/collision.py`` (:40-162, :359-382): the geom,
obstacle and collision-model types, their builders, the self-collision
candidate pairs, and the ground-contact list that the ground steppers read
(one contact per sphere, two per capsule: each endpoint sphere touches the
ground on its own). One primitive serves every shape: the capsule, a
segment [a, b] in a link's frame with radius r; a sphere is a == b.

A geom set is concrete geometry here: its tensors hold numbers the steppers
read once a set (the kernels take the endpoints and radii as run-time
arguments). The JAX package's traced branch of the ground-contact list (two
contacts for any traced geom) has no counterpart. The collision row
builders (the distances and the self-collision and obstacle rows of the
free-flyer stepper) wait for ROADMAP Queue 1, 'Ground stepping, part
three'.
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
    link pairs."""
    geoms: Geoms
    pairs: Tuple[Tuple[int, int], ...]
    obstacles: Optional[Obstacles]
    obs_pairs: Tuple[Tuple[int, int], ...]

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
    return CollisionModel(geoms, tuple(pairs), obstacles, tuple(obs_pairs))


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
