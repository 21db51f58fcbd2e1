"""URDF → robot description.

A copy of ``gridcodegenerator_tpu/models/urdf.py`` (plain NumPy), with the
free-flyer helper ``demote_floating_root``: the JAX package's ``__init__``
imports jax, so the port carries its own copy.

Replaces the reference's external ``URDFParser`` dependency
(``README.md:8,20``; required API surveyed in SURVEY.md §2.7).
Parses the URDF XML directly (stdlib ``xml.etree``), merges fixed joints into
their moving parents, orders joints topologically, and produces the numeric
per-joint data the dynamics layer needs:

* ``Topology``            — static tree structure,
* origin transforms       — (xyz, rpy) per joint,
* joint axes / types      — revolute | continuous | prismatic,
* viscous damping         — per joint (the reference golden model's damping
                            term, ``_test.py:103-105``),
* spatial inertia (6×6)   — per moving link, Featherstone convention with
                            [angular; linear] coordinate ordering.

Spatial-algebra conventions (shared with :mod:`..ops.spatial`): a motion
vector is ``[ω; v]``; the motion transform from parent to child coordinates is
``X = [[E, 0], [-E·r̂, E]]`` with ``E`` the parent→child rotation and ``r`` the
child origin expressed in parent coordinates.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

from .topology import Topology

_MOVING_TYPES = ("revolute", "continuous", "prismatic", "spherical",
                 "floating")


# --------------------------------------------------------------------------
# Small SO(3)/SE(3) helpers (NumPy, parse-time only)
# --------------------------------------------------------------------------
def skew(v: np.ndarray) -> np.ndarray:
    x, y, z = v
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF rpy → rotation matrix R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def homogeneous(R: np.ndarray, p: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def spatial_inertia(mass: float, com: np.ndarray, I_com: np.ndarray) -> np.ndarray:
    """6×6 spatial inertia in link coordinates from mass, COM offset and the
    3×3 rotational inertia *about the COM* expressed in link coordinates."""
    C = skew(com)
    I6 = np.zeros((6, 6))
    I6[:3, :3] = I_com + mass * (C @ C.T)
    I6[:3, 3:] = mass * C
    I6[3:, :3] = mass * C.T
    I6[3:, 3:] = mass * np.eye(3)
    return I6


def transform_spatial_inertia(I6: np.ndarray, R: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Express a spatial inertia given in frame B in frame A, where frame B's
    pose in A is (R, p): ``I_A = X^T I_B X`` with ``X = X_{B←A}``."""
    E = R.T  # A→B rotation
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ skew(p)
    return X.T @ I6 @ X


# --------------------------------------------------------------------------
# Parsed description
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class RobotDescription:
    """Numeric robot description, topologically ordered, fixed joints merged."""

    name: str
    topology: Topology
    joint_types: tuple[str, ...]          # 'revolute' | 'prismatic' | 'spherical'
    origin_xyz: np.ndarray                # (n, 3) joint origin in parent link frame
    origin_rpy: np.ndarray                # (n, 3)
    axis: np.ndarray                      # (n, 3) joint axis in joint frame (unit)
    damping: np.ndarray                   # (n,)
    inertia: np.ndarray                   # (n, 6, 6) moving-link spatial inertias
    base_inertia: np.ndarray              # (6, 6) inertia lumped into the fixed base
    # URDF <limit> tags (±inf / inf when absent — continuous joints etc.)
    q_lower: np.ndarray = None            # (n,)
    q_upper: np.ndarray = None            # (n,)
    effort: np.ndarray = None             # (n,) max |τ|
    velocity: np.ndarray = None           # (n,) max |q̇|
    # reflected rotor inertia (MuJoCo's "armature"; URDF has no standard tag —
    # parsed from the nonstandard <dynamics armature="..."> attribute). Adds
    # armatureᵢ·q̈ᵢ to joint i's torque, i.e. M → M + diag(armature).
    armature: np.ndarray = None           # (n,)
    # Coulomb (dry) joint friction — URDF <dynamics friction="...">,
    # MJCF joint ``frictionloss``. The tree dynamics do NOT apply it;
    # the ground steppers take it as box impulse rows
    # (``frictionloss=`` on fb_step_ground(_batched)).
    frictionloss: np.ndarray = None       # (n,)
    # URDF <mimic> tags: linear transmission couplings q_j = m·q_k + o,
    # each entry (joint_idx j, source_idx k, multiplier m, offset o) over
    # moving-joint indices. The tree dynamics do NOT enforce these — build
    # the constraint rows with ``ops/loops.py::transmission_rows`` and run
    # ``loop_forward_dynamics(couplings=...)`` (gear trains, two-finger
    # grippers, differentials).
    mimic: tuple = ()

    @property
    def n(self) -> int:
        return self.topology.n


def _parse_origin(el) -> tuple[np.ndarray, np.ndarray]:
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if el is not None:
        o = el.find("origin")
        if o is not None:
            if o.get("xyz"):
                xyz = np.array([float(s) for s in o.get("xyz").split()])
            if o.get("rpy"):
                rpy = np.array([float(s) for s in o.get("rpy").split()])
    return xyz, rpy


def _parse_link_inertia(link_el) -> tuple[float, np.ndarray, np.ndarray]:
    """Return (mass, com_in_link, I_com_in_link_coords)."""
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    xyz, rpy = _parse_origin_direct(inertial)
    R = rpy_to_matrix(rpy)
    it = inertial.find("inertia")
    ixx = float(it.get("ixx", 0)); iyy = float(it.get("iyy", 0)); izz = float(it.get("izz", 0))
    ixy = float(it.get("ixy", 0)); ixz = float(it.get("ixz", 0)); iyz = float(it.get("iyz", 0))
    I_principal = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # Rotate the COM-frame inertia into link coordinates.
    return mass, xyz, R @ I_principal @ R.T


def _parse_origin_direct(el) -> tuple[np.ndarray, np.ndarray]:
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    o = el.find("origin")
    if o is not None:
        if o.get("xyz"):
            xyz = np.array([float(s) for s in o.get("xyz").split()])
        if o.get("rpy"):
            rpy = np.array([float(s) for s in o.get("rpy").split()])
    return xyz, rpy


def parse_urdf(source: str, *, merge_fixed: bool = True) -> RobotDescription:
    """Parse a URDF document (XML string or file path) into a
    :class:`RobotDescription`."""
    text = source
    if "<" not in source:  # looks like a path
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError("not a URDF document (missing <robot> root)")
    name = root.get("name", "robot")

    links: dict[str, ET.Element] = {}
    for link in root.findall("link"):
        links[link.get("name")] = link

    joints = []
    child_links = set()
    for j in root.findall("joint"):
        jtype = j.get("type")
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        if child in child_links:
            raise ValueError(f"link {child} has two parent joints (not a tree)")
        child_links.add(child)
        xyz, rpy = _parse_origin_direct(j)
        axis = np.array([0.0, 0.0, 1.0])
        ax = j.find("axis")
        if ax is not None and ax.get("xyz"):
            axis = np.array([float(s) for s in ax.get("xyz").split()])
        damping = 0.0
        armature = 0.0
        friction = 0.0
        dyn = j.find("dynamics")
        if dyn is not None and dyn.get("damping"):
            damping = float(dyn.get("damping"))
        if dyn is not None and dyn.get("armature"):
            armature = float(dyn.get("armature"))
        if dyn is not None and dyn.get("friction"):
            friction = float(dyn.get("friction"))
        lim = j.find("limit")
        inf = float("inf")
        limits = dict(lower=-inf, upper=inf, effort=inf, velocity=inf)
        if lim is not None and jtype != "continuous":
            for key in limits:
                if lim.get(key) is not None:
                    limits[key] = float(lim.get(key))
        if jtype not in _MOVING_TYPES + ("fixed",):
            raise NotImplementedError(
                f"joint type {jtype!r} not supported (supported: "
                f"{_MOVING_TYPES + ('fixed',)}; 'spherical'/'floating' "
                "require the multi-dof stack, ops/multidof.py)"
            )
        mimic_el = j.find("mimic")
        mimic = None
        if mimic_el is not None:
            mimic = (mimic_el.get("joint"),
                     float(mimic_el.get("multiplier", 1.0)),
                     float(mimic_el.get("offset", 0.0)))
        joints.append(dict(
            name=j.get("name"), type=jtype, parent=parent, child=child,
            xyz=xyz, rpy=rpy, axis=axis, damping=damping,
            armature=armature, friction=friction, limits=limits,
            mimic=mimic,
        ))

    root_links = [ln for ln in links if ln not in child_links]
    if len(root_links) != 1:
        raise ValueError(f"expected exactly one root link, found {root_links}")
    root_link = root_links[0]

    # ----- walk the tree in DFS document order, merging fixed joints --------
    by_parent_link: dict[str, list[dict]] = {}
    for j in joints:
        by_parent_link.setdefault(j["parent"], []).append(j)

    # accumulated link inertia (mass, com, I_com) → lump fixed children in
    link_inertia6: dict[str, np.ndarray] = {}
    for ln, el in links.items():
        m, com, I_com = _parse_link_inertia(el)
        link_inertia6[ln] = spatial_inertia(m, com, I_com)

    ordered: list[dict] = []       # moving joints, topological order
    parent_of: list[int] = []      # moving-joint parent indices
    moving_link: list[str] = []    # child link of each moving joint

    def visit(link: str, parent_joint_idx: int, T_acc: np.ndarray):
        """``T_acc``: pose of `link` in the frame of its governing moving
        link (identity unless we passed through fixed joints)."""
        for j in by_parent_link.get(link, ()):
            if j["type"] == "fixed" and merge_fixed:
                R = rpy_to_matrix(j["rpy"])
                T_child = T_acc @ homogeneous(R, j["xyz"])
                # lump the fixed child's inertia into the governing link
                I6 = transform_spatial_inertia(
                    link_inertia6[j["child"]], T_child[:3, :3], T_child[:3, 3])
                target = moving_link[parent_joint_idx] if parent_joint_idx >= 0 else root_link
                link_inertia6[target] = link_inertia6[target] + I6
                visit(j["child"], parent_joint_idx, T_child)
            else:
                # compose any accumulated fixed transform into the origin
                R = rpy_to_matrix(j["rpy"])
                T_origin = T_acc @ homogeneous(R, j["xyz"])
                idx = len(ordered)
                ordered.append(dict(j, T_origin=T_origin))
                parent_of.append(parent_joint_idx)
                moving_link.append(j["child"])
                visit(j["child"], idx, np.eye(4))

    visit(root_link, -1, np.eye(4))
    # `visit` lumped fixed-subtree inertias; now gather per moving link.
    n = len(ordered)
    if n == 0:
        raise ValueError("robot has no moving joints")

    inertia = np.stack([link_inertia6[ln] for ln in moving_link])
    origin_xyz = np.stack([j["T_origin"][:3, 3] for j in ordered])
    # recover rpy-free representation: keep the rotation matrix directly
    origin_R = np.stack([j["T_origin"][:3, :3] for j in ordered])
    axis = np.stack([j["axis"] / np.linalg.norm(j["axis"]) for j in ordered])
    damping = np.array([j["damping"] for j in ordered])
    armature = np.array([j["armature"] for j in ordered])
    friction = np.array([j["friction"] for j in ordered])
    lims = {key: np.array([j["limits"][key] for j in ordered])
            for key in ("lower", "upper", "effort", "velocity")}
    types = tuple("revolute" if j["type"] == "continuous" else j["type"] for j in ordered)

    # resolve <mimic> references to moving-joint indices (fail fast on
    # references to fixed/merged or unknown joints)
    name_to_idx = {j["name"]: i for i, j in enumerate(ordered)}
    mimic = []
    for i, j in enumerate(ordered):
        if j.get("mimic") is None:
            continue
        src, mult, off = j["mimic"]
        if src not in name_to_idx:
            raise ValueError(
                f"joint {j['name']!r} mimics {src!r}, which is not a moving "
                "joint (fixed/merged or missing)")
        mimic.append((i, name_to_idx[src], mult, off))

    topo = Topology(
        parents=tuple(parent_of),
        joint_names=tuple(j["name"] for j in ordered),
        link_names=tuple(moving_link),
    )
    desc = RobotDescription(
        name=name, topology=topo, joint_types=types,
        origin_xyz=origin_xyz,
        origin_rpy=np.stack([_matrix_to_rpy(R) for R in origin_R]),
        axis=axis, damping=damping, inertia=inertia,
        base_inertia=link_inertia6[root_link],
        q_lower=lims["lower"], q_upper=lims["upper"],
        effort=lims["effort"], velocity=lims["velocity"],
        armature=armature, frictionloss=friction, mimic=tuple(mimic),
    )
    return desc


def _matrix_to_rpy(R: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rpy_to_matrix` (ZYX Euler extraction)."""
    sy = -R[2, 0]
    sy = np.clip(sy, -1.0, 1.0)
    p = np.arcsin(sy)
    if abs(sy) < 1.0 - 1e-12:
        r = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        r = np.arctan2(-R[1, 2], R[1, 1])
        y = 0.0
    return np.array([r, p, y])


def demote_floating_root(desc: RobotDescription) -> RobotDescription:
    """Strip a single root ``floating`` joint from a description whose other
    joints are all single-dof, returning the fixed-base arm description the
    free-flyer stack expects (``ops/freeflyer.py::free_flyer_model``): the
    floating joint's child link becomes the base (its spatial inertia lumps
    into ``base_inertia``), every other joint index shifts down by one, and
    joints that hung off the old root re-parent to the base (-1).

    This is the MJCF ``<freejoint/>`` → free-flyer bridge: MuJoCo models
    write the floating base as an explicit joint, while the engine's
    fixed-base + ``FreeFlyerModel`` layering keeps it out of the tree (the
    fused contact kernels are specialized to single-dof arms). Use the
    multi-dof stack instead when other ball/free joints remain."""
    types = desc.joint_types
    if not types or types[0] != "floating":
        raise ValueError("joint 0 is not a floating root")
    if any(t in ("spherical", "floating") for t in types[1:]):
        raise ValueError(
            "tree keeps multi-dof joints after the root — use the multi-dof "
            "stack (multidof_model_from_description), not the free-flyer "
            "demotion")
    if any(p == -1 for p in desc.topology.parents[1:]):
        raise ValueError("multiple root joints — cannot demote")
    sl = slice(1, None)
    opt = lambda a: None if a is None else np.asarray(a)[sl]
    topo = desc.topology
    new_parents = tuple(p - 1 for p in topo.parents[1:])
    names = lambda t: t[1:] if len(t) == topo.n else t
    return RobotDescription(
        name=desc.name,
        topology=Topology(new_parents,
                          joint_names=names(topo.joint_names),
                          link_names=names(topo.link_names)),
        joint_types=types[1:],
        origin_xyz=np.asarray(desc.origin_xyz)[sl],
        origin_rpy=np.asarray(desc.origin_rpy)[sl],
        axis=np.asarray(desc.axis)[sl],
        damping=np.asarray(desc.damping)[sl],
        inertia=np.asarray(desc.inertia)[sl],
        base_inertia=np.asarray(desc.base_inertia) + np.asarray(desc.inertia)[0],
        q_lower=opt(desc.q_lower), q_upper=opt(desc.q_upper),
        effort=opt(desc.effort), velocity=opt(desc.velocity),
        armature=opt(desc.armature),
        frictionloss=opt(desc.frictionloss),
        mimic=tuple((j - 1, k - 1, m, o) for j, k, m, o in desc.mimic),
    )
