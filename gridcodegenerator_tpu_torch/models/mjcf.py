"""MJCF (MuJoCo XML) → :class:`.urdf.RobotDescription`.

The port's copy of ``gridcodegenerator_tpu/models/mjcf.py``: the same
NumPy parser (the JAX package's one jax import, in
:func:`mjcf_collision_model`, becomes torch here), so the two packages read
a document into equal descriptions. It extends the URDF intake
(:mod:`.urdf`) to MuJoCo's format, where most modern RL robot assets ship.
The output is the same :class:`~.urdf.RobotDescription`, so every
downstream constructor works unchanged: ``robot_model_from_description``
(single-dof trees), ``free_flyer_model`` (floating base), and
``multidof_model_from_description`` (ball / in-tree free joints).

Supported MJCF subset (stdlib ``xml.etree``, no MuJoCo dependency):

* ``<compiler>``: ``angle`` (degree — the MJCF default — or radian),
  ``eulerseq`` (any permutation of x/y/z; lowercase = intrinsic / moving
  axes, uppercase = extrinsic / fixed axes, per the MJCF reference),
  ``inertiafromgeom`` (auto | true | false).
* ``<default>`` classes with nesting/inheritance for ``joint`` and ``geom``
  attributes (``class=`` on elements, ``childclass=`` on bodies).
* ``<worldbody>`` body tree: ``pos`` + one of ``quat`` (wxyz) / ``euler`` /
  ``axisangle`` / ``zaxis`` / ``xyaxes``.
* joints: ``hinge`` (default) | ``slide`` | ``ball`` | ``free`` and the
  ``<freejoint>`` shorthand; joint ``pos`` (anchor) and ``axis`` live in the
  BODY frame. The emitted moving-link frame is the body frame translated to
  the joint anchor, so the description's joint origin is
  ``T_parent_body · Trans(anchor)`` and the axis carries over unchanged —
  the exact MJCF kinematics (anchor-preserving local rotation,
  ``mj_kinematics``). Multiple joints in one body compose in document order
  (first joint outermost, each post-multiplying in the local frame, as in
  MuJoCo) and are emitted as a chain through massless intermediate links.
* ``<inertial>``: ``pos``/``quat``/``mass`` + ``diaginertia`` or
  ``fullinertia``. Bodies without an inertial element derive mass
  properties from their geoms like MuJoCo's compiler does
  (``inertiafromgeom="auto"``): sphere, capsule, cylinder, box, ellipsoid,
  with ``mass`` or ``density`` (default 1000) and ``fromto`` support.
* joint ``damping``, ``armature``, ``range`` (+ ``limited``),
  ``actuatorfrcrange`` → the description's damping / armature / q-limits /
  effort fields.
* jointless bodies are welded into their governing moving link (inertia
  lumped through the accumulated fixed transform), exactly like the URDF
  parser's fixed-joint merging.

Beyond the kinematic tree, the document's auxiliary blocks are parsed by
dedicated accessors: ``<equality>`` (:func:`mjcf_loops` / :func:`mjcf_welds`
/ mimic couplings), ``<site>`` frames (:func:`mjcf_sites`), ``<actuator>``
(:func:`mjcf_actuators` — motor / position / velocity servos with joint OR
fixed-tendon transmission), ``<sensor>`` (:func:`mjcf_sensors`), and
``<tendon><fixed>`` (:func:`mjcf_tendons` — length coupling, passive
spring/damper forces, ranges for the steppers' ``tendons=`` limit rows).

Not supported (raises or ignored, see code): ``<include>``, spatial
(wrapping) tendons, ``coordinate="global"`` (removed from modern MuJoCo).
Collision geometry is parsed structurally but only consumed for inertia
synthesis here — build :class:`~..ops.collision.CollisionModel` sets
separately. The actuation and tendon helpers' state-dependent laws
(:meth:`MjcfActuation.torque`, :meth:`MjcfTendons.passive_torque`) work on
NumPy arrays.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from .topology import Topology
from .urdf import (RobotDescription, homogeneous, skew, spatial_inertia,
                   transform_spatial_inertia, _matrix_to_rpy)

_INF = float("inf")


# --------------------------------------------------------------------------
# numeric attribute helpers
# --------------------------------------------------------------------------
def _floats(s):
    return np.array([float(v) for v in s.split()])


def _attr(el, defaults, name, fallback=None):
    """Element attribute with <default> class fallback."""
    v = el.get(name)
    if v is not None:
        return v
    return defaults.get(name, fallback)


def _axis_rot(axis: int, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    R = np.eye(3)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R[i, i] = c
    R[j, j] = c
    R[i, j] = -s
    R[j, i] = s
    return R


def _quat_to_mat(q) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _orientation(el, defaults, compiler) -> np.ndarray:
    """Rotation matrix from whichever MJCF orientation attribute is present
    (quat default = identity)."""
    deg = compiler["angle"] == "degree"
    to_rad = np.pi / 180.0 if deg else 1.0
    quat = _attr(el, defaults, "quat")
    if quat is not None:
        return _quat_to_mat(_floats(quat))
    euler = _attr(el, defaults, "euler")
    if euler is not None:
        ang = _floats(euler) * to_rad
        R = np.eye(3)
        for ch, a in zip(compiler["eulerseq"], ang):
            Ri = _axis_rot("xyz".index(ch.lower()), a)
            # lowercase: intrinsic (post-multiply); uppercase: extrinsic
            R = R @ Ri if ch.islower() else Ri @ R
        return R
    axisangle = _attr(el, defaults, "axisangle")
    if axisangle is not None:
        v = _floats(axisangle)
        ax = v[:3] / np.linalg.norm(v[:3])
        a = v[3] * to_rad
        K = skew(ax)
        return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    zaxis = _attr(el, defaults, "zaxis")
    if zaxis is not None:
        z = _floats(zaxis)
        z = z / np.linalg.norm(z)
        ref = np.array([1.0, 0.0, 0.0])
        if abs(z[0]) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        x = np.cross(ref, z)
        x /= np.linalg.norm(x)
        return np.column_stack([x, np.cross(z, x), z])
    xyaxes = _attr(el, defaults, "xyaxes")
    if xyaxes is not None:
        v = _floats(xyaxes)
        x = v[:3] / np.linalg.norm(v[:3])
        y = v[3:] - np.dot(v[3:], x) * x
        y /= np.linalg.norm(y)
        return np.column_stack([x, y, np.cross(x, y)])
    return np.eye(3)


def _pose(el, defaults, compiler) -> np.ndarray:
    pos = _attr(el, defaults, "pos")
    p = _floats(pos) if pos is not None else np.zeros(3)
    return homogeneous(_orientation(el, defaults, compiler), p)


# --------------------------------------------------------------------------
# <default> class resolution
# --------------------------------------------------------------------------
def _collect_defaults(root) -> dict:
    """class name → {tag → {attr → value}} with nested-class inheritance."""
    table = {}

    def walk(el, inherited, cls):
        merged = {tag: dict(attrs) for tag, attrs in inherited.items()}
        for child in el:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {}).update(child.attrib)
        table[cls] = merged
        for child in el.findall("default"):
            walk(child, merged, child.get("class", cls))

    top = root.find("default")
    if top is not None:
        walk(top, {}, top.get("class", "main"))
    table.setdefault("main", {})
    return table


def _defaults_for(table, tag, cls):
    return table.get(cls, table["main"]).get(tag, {})


# --------------------------------------------------------------------------
# geom-derived inertia (MuJoCo inertiafromgeom semantics)
# --------------------------------------------------------------------------
def _geom_mass_inertia(geom, defaults, compiler):
    """(mass, com_in_body, I_com_in_body) for one geom, or None if the geom
    carries no mass (plane / mesh without explicit mass)."""
    gtype = _attr(geom, defaults, "type", "sphere")
    size_s = _attr(geom, defaults, "size")
    size = _floats(size_s) if size_s is not None else np.zeros(0)
    fromto = _attr(geom, defaults, "fromto")
    if fromto is not None:
        ft = _floats(fromto)
        a, b = ft[:3], ft[3:]
        center = 0.5 * (a + b)
        d = b - a
        h = 0.5 * np.linalg.norm(d)
        z = d / (2 * h) if h > 0 else np.array([0.0, 0.0, 1.0])
        ref = np.array([1.0, 0.0, 0.0])
        if abs(z[0]) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        x = np.cross(ref, z)
        x /= np.linalg.norm(x)
        R = np.column_stack([x, np.cross(z, x), z])
        T = homogeneous(R, center)
    else:
        h = size[1] if size.shape[0] > 1 else 0.0
        T = _pose(geom, defaults, compiler)
    R, p = T[:3, :3], T[:3, 3]

    r = size[0] if size.shape[0] else 0.0
    if gtype == "sphere":
        vol = 4.0 / 3.0 * np.pi * r ** 3
        diag = np.full(3, 2.0 / 5.0 * r ** 2)
    elif gtype == "capsule":
        v_cyl = np.pi * r * r * (2 * h)
        v_sph = 4.0 / 3.0 * np.pi * r ** 3
        vol = v_cyl + v_sph
        fc = v_cyl / vol
        fs = v_sph / vol
        iz = fc * (r * r / 2) + fs * (2 * r * r / 5)
        ix = (fc * (3 * r * r + 4 * h * h) / 12
              + fs * (2 * r * r / 5 - 9 * r * r / 64
                      + (h + 3 * r / 8) ** 2))
        diag = np.array([ix, ix, iz])
    elif gtype == "cylinder":
        vol = np.pi * r * r * (2 * h)
        diag = np.array([(3 * r * r + 4 * h * h) / 12,
                         (3 * r * r + 4 * h * h) / 12, r * r / 2])
    elif gtype == "box":
        a_, b_, c_ = size[:3]
        vol = 8 * a_ * b_ * c_
        diag = np.array([(b_ ** 2 + c_ ** 2), (a_ ** 2 + c_ ** 2),
                         (a_ ** 2 + b_ ** 2)]) / 3.0
    elif gtype == "ellipsoid":
        a_, b_, c_ = size[:3]
        vol = 4.0 / 3.0 * np.pi * a_ * b_ * c_
        diag = np.array([(b_ ** 2 + c_ ** 2), (a_ ** 2 + c_ ** 2),
                         (a_ ** 2 + b_ ** 2)]) / 5.0
    else:
        return None                         # plane / mesh / hfield: massless

    mass_s = _attr(geom, defaults, "mass")
    if mass_s is not None:
        mass = float(mass_s)
    else:
        density = float(_attr(geom, defaults, "density", "1000"))
        mass = density * vol
    I_local = mass * np.diag(diag)
    return mass, p, R @ I_local @ R.T


def _body_inertia_from_geoms(body, defaults_table, compiler, cls):
    """Sum geom inertias → (mass, com, I_com) in body coordinates."""
    parts = []
    for geom in body.findall("geom"):
        gcls = geom.get("class", cls)
        d = _defaults_for(defaults_table, "geom", gcls)
        mi = _geom_mass_inertia(geom, d, compiler)
        if mi is not None and mi[0] > 0:
            parts.append(mi)
    if not parts:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    m = sum(p[0] for p in parts)
    com = sum(p[0] * p[1] for p in parts) / m
    I = np.zeros((3, 3))
    for mi, ci, Ii in parts:
        d = ci - com
        I += Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m, com, I


def _body_inertial(body, defaults_table, compiler, cls):
    """6×6 spatial inertia of one body, in body coordinates."""
    inertial = body.find("inertial")
    ifg = compiler["inertiafromgeom"]
    if inertial is None or ifg == "true":
        if inertial is None and ifg == "false":
            return np.zeros((6, 6))
        m, com, I_com = _body_inertia_from_geoms(body, defaults_table,
                                                 compiler, cls)
        return spatial_inertia(m, com, I_com)
    mass = float(inertial.get("mass"))
    pos = inertial.get("pos")
    com = _floats(pos) if pos is not None else np.zeros(3)
    R = _orientation(inertial, {}, compiler)
    di = inertial.get("diaginertia")
    if di is not None:
        I_p = np.diag(_floats(di))
    else:
        fi = _floats(inertial.get("fullinertia"))
        I_p = np.array([[fi[0], fi[3], fi[4]],
                        [fi[3], fi[1], fi[5]],
                        [fi[4], fi[5], fi[2]]])
    return spatial_inertia(mass, com, R @ I_p @ R.T)


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------
_JOINT_TYPES = {"hinge": "revolute", "slide": "prismatic",
                "ball": "spherical", "free": "floating"}


def parse_mjcf(source: str) -> RobotDescription:
    """Parse an MJCF document (XML string or file path) into a
    :class:`~.urdf.RobotDescription`."""
    return _parse_mjcf_impl(source)[0]


class MjcfSite(NamedTuple):
    """A named MJCF ``<site>`` re-expressed in the parsed description's
    frames: ``link`` is the governing moving link (-1 = the root weld —
    the floating base under ``free_flyer_model`` — and -2 = a static
    worldbody site), ``pos``/``R`` the site frame in that link's
    coordinates. Foot anchors for the ground steppers come straight from
    here: ``offsets = [sites[f].pos for f in feet]``."""
    link: int
    pos: np.ndarray            # (3,)
    R: np.ndarray              # (3, 3)


def mjcf_sites(source: str) -> "dict[str, MjcfSite]":
    """Extract the document's named ``<site>`` frames (MuJoCo's standard
    anchor idiom for feet, sensors, and end-effectors) in moving-link
    coordinates — the same weld/anchor re-expression as
    :func:`mjcf_collision_model`'s geoms."""
    _, _, extras = _parse_mjcf_impl(source)
    return {name: MjcfSite(link, T[:3, 3].copy(), T[:3, :3].copy())
            for name, link, T in extras["sites"]}


def mjcf_loops(source: str):
    """Extract the document's ``<equality><connect>`` constraints (MuJoCo's
    loop-closure idiom — parallel linkages, self-grasps) as the engine's
    ``loops = (pairs, offsets_a, offsets_b)`` spec, ready for
    ``loop_forward_dynamics`` / ``loops=`` on the ground steppers.
    Anchors follow MuJoCo's convention: body2's local point is derived at
    the zero configuration. Cut faces on jointless ROOT bodies (the torso
    weld) or the worldbody become world pins (``link_b = -1``, world
    anchor) — correct for the fixed-base reading; a floating-base
    promotion would pin them to the WORLD, not the base.

    Joint-space equalities (``<equality><joint>`` linear polycoef) land in
    ``RobotDescription.mimic`` instead — feed ``transmission_rows`` /
    ``couplings=``. Returns ``None`` when the document has no connects."""
    desc, _, extras = _parse_mjcf_impl(source)
    if not extras["connects"]:
        return None
    pairs, oa, ob = [], [], []
    for l1, o1, l2, o2 in extras["connects"]:
        if l1 < 0 and l2 < 0:
            raise ValueError(
                "connect between two world/root-welded bodies constrains "
                "nothing the tree can move")
        if l1 < 0:                              # world side first → swap
            l1, o1, l2, o2 = l2, o2, l1, o1
        pairs.append((l1, -1 if l2 < 0 else l2))
        oa.append(o1)
        ob.append(o2)
    return tuple(pairs), np.stack(oa), np.stack(ob)


def mjcf_welds(source: str):
    """Extract the document's ``<equality><weld>`` constraints as
    ``(pairs, offsets_a, offsets_b, R0 (w, 3, 3))``: the anchor halves
    follow :func:`mjcf_loops`' connect convention (feed them into
    ``loops=`` — they ARE connect rows), ``R0`` is the qpos0 relative
    link rotation for the 3 orientation rows (``welds=(pairs, R0)`` on
    the free-flyer ground steppers, the JAX package's ``ops/loops.py``).
    World/root-welded second bodies become world welds (``link_b = -1``).
    Returns ``None`` when the document has no welds."""
    desc, _, extras = _parse_mjcf_impl(source)
    if not extras["welds"]:
        return None
    pairs, oa, ob, R0s = [], [], [], []
    for l1, o1, l2, o2, R0 in extras["welds"]:
        if l1 < 0 and l2 < 0:
            raise ValueError(
                "weld between two world/root-welded bodies constrains "
                "nothing the tree can move")
        if l1 < 0:                              # world side first → swap
            l1, o1, l2, o2 = l2, o2, l1, o1
            R0 = R0.T                           # R_w_a·R0 = R_w_b swapped
        pairs.append((l1, -1 if l2 < 0 else l2))
        oa.append(o1)
        ob.append(o2)
        R0s.append(R0)
    return tuple(pairs), np.stack(oa), np.stack(ob), np.stack(R0s)


class MjcfActuation(NamedTuple):
    """The document's ``<actuator>`` block. For pure torque motors the
    transmission is τ = gear_matrix() @ clamp(ctrl); position/velocity
    servos follow MuJoCo's affine actuator model — per actuator
    ``force = gain·ctrl + bias_q·(gear·q_j) + bias_v·(gear·q̇_j)`` with
    (gain, bias_q, bias_v) = (1, 0, 0) for motors, (kp, −kp, −kv) for
    ``<position>``, (kv, 0, −kv) for ``<velocity>``; the applied joint
    torque is gear·force, force clamped to ``forcerange``. Use
    :meth:`torque` for the full state-dependent law. ``joint[i]`` is
    actuator i's moving-joint index, ``ctrl_lower/upper`` the ctrlrange
    (±inf when unlimited)."""
    n: int                     # moving-joint count of the model
    names: "tuple[str, ...]"
    joint: np.ndarray          # (a,) int
    gear: np.ndarray           # (a,)
    ctrl_lower: np.ndarray     # (a,)
    ctrl_upper: np.ndarray     # (a,)
    kind: "tuple[str, ...]" = ()        # 'motor'|'general'|'position'|...
    kp: np.ndarray = None      # (a,) position gain
    kv: np.ndarray = None      # (a,) velocity gain
    force_lower: np.ndarray = None      # (a,) forcerange
    force_upper: np.ndarray = None
    # transmission generalization (tendon actuators): moment[i] is the
    # gear-scaled (n,) transmission row — actuator length = moment·q,
    # applied torque = force·moment. For joint actuators moment = gear·e_j
    # (the two paths agree); tendon[i] ≥ 0 indexes mjcf_tendons() rows and
    # joint[i] is −1 for those actuators.
    moment: np.ndarray = None  # (a, n)
    tendon: np.ndarray = None  # (a,) int, −1 = joint transmission

    def gains(self):
        """(gain, bias_q, bias_v) arrays of the affine actuator model."""
        kinds = self.kind or ("motor",) * len(self.joint)
        kp = self.kp if self.kp is not None else np.ones(len(self.joint))
        kv = self.kv if self.kv is not None else np.zeros(len(self.joint))
        gain = np.array([kp[i] if k == "position"
                         else kv[i] if k == "velocity" else 1.0
                         for i, k in enumerate(kinds)])
        bias_q = np.array([-kp[i] if k == "position" else 0.0
                           for i, k in enumerate(kinds)])
        bias_v = np.array([-kv[i] if k in ("position", "velocity") else 0.0
                           for i, k in enumerate(kinds)])
        return gain, bias_q, bias_v

    def torque(self, ctrl, q, qd):
        """Joint torques (..., n) from controls (..., a) and the joint
        state (..., n) — the full MuJoCo actuator law (ctrlrange clamp,
        affine gain/bias, forcerange clamp, gear transmission). Works on
        NumPy arrays; fixed-base moving-joint indexing."""
        c = self.clamp(ctrl)
        gain, bias_q, bias_v = self.gains()
        if self.moment is not None:
            # generic transmission path (covers tendon actuators): the
            # actuator's length/velocity are moment·q / moment·q̇ and the
            # applied torque is force·moment — identical to the indexed
            # path for joint actuators, where moment = gear·e_j
            qj = q @ self.moment.T
            qdj = qd @ self.moment.T
        else:
            gear = self.gear
            qj = q[..., self.joint] * gear
            qdj = qd[..., self.joint] * gear
        f = gain * c + bias_q * qj + bias_v * qdj
        if self.force_lower is not None:
            lo = np.where(np.isfinite(self.force_lower), self.force_lower,
                          -np.finfo(np.float64).max)
            hi = np.where(np.isfinite(self.force_upper), self.force_upper,
                          np.finfo(np.float64).max)
            f = f.clip(lo, hi)
        if self.moment is not None:
            return f @ self.moment
        gear = self.gear
        tau = q * 0.0
        np.add.at(tau, (..., self.joint), gear * f)
        return tau

    def gear_matrix(self) -> np.ndarray:
        """(n, a) map from actuator controls to joint torques."""
        if self.moment is not None:
            return np.asarray(self.moment).T.copy()
        T = np.zeros((self.n, self.joint.shape[0]))
        for i, (j, s) in enumerate(zip(self.joint, self.gear)):
            T[j, i] += s
        return T

    def clamp(self, ctrl):
        """Clip controls to ctrlrange (NumPy arrays, or any array with a
        ``clip`` method)."""
        lo = np.where(np.isfinite(self.ctrl_lower), self.ctrl_lower,
                      -np.finfo(np.float64).max)
        hi = np.where(np.isfinite(self.ctrl_upper), self.ctrl_upper,
                      np.finfo(np.float64).max)
        return ctrl.clip(lo, hi) if hasattr(ctrl, "clip") else np.clip(
            ctrl, lo, hi)


def mjcf_actuators(source: str) -> MjcfActuation:
    """Extract the document's ``<actuator>`` block (motor / torque-mode
    general / position / velocity with joint or fixed-tendon
    transmission): gears, ctrlranges, the joint map, and the gear-scaled
    transmission (moment) rows, so RL policies emitting per-actuator
    controls drive the steppers via ``tau = act.torque(ctrl, q, qd)``."""
    desc, _, extras = _parse_mjcf_impl(source)
    acts = extras["actuators"]
    return MjcfActuation(
        n=desc.n,
        names=tuple(a["name"] for a in acts),
        joint=np.array([a["joint"] for a in acts], dtype=np.int64),
        gear=np.array([a["gear"] for a in acts], dtype=np.float64),
        ctrl_lower=np.array([a["lo"] for a in acts], dtype=np.float64),
        ctrl_upper=np.array([a["hi"] for a in acts], dtype=np.float64),
        kind=tuple(a["kind"] for a in acts),
        kp=np.array([a["kp"] for a in acts], dtype=np.float64),
        kv=np.array([a["kv"] for a in acts], dtype=np.float64),
        force_lower=np.array([a["flo"] for a in acts], dtype=np.float64),
        force_upper=np.array([a["fhi"] for a in acts], dtype=np.float64),
        moment=(np.stack([a["moment"] for a in acts])
                if acts else np.zeros((0, desc.n))),
        tendon=np.array([a["tendon"] for a in acts], dtype=np.int64),
    )


class MjcfTendons(NamedTuple):
    """The document's ``<tendon><fixed>`` rows: joint-space length
    couplings ``L_t = Σ_j coef[t, j]·q_j`` over the moving joints (scalar
    hinge/slide joints only — MuJoCo's fixed-tendon semantics). Carries
    the range (±inf when unlimited — feed :meth:`stepper_rows` to the
    steppers' ``tendons=`` for hard limit rows in the contact solve) and
    the passive spring/damper parameters (``stiffness`` toward
    ``springlength``, ``damping`` on L̇ — :meth:`passive_torque` is the
    generalized-force form to add to τ)."""
    n: int                     # moving-joint count of the model
    names: "tuple[str, ...]"
    coef: np.ndarray           # (t, n) joint coefficients
    lo: np.ndarray             # (t,) range (±inf = unlimited)
    hi: np.ndarray
    stiffness: np.ndarray      # (t,) passive spring gain
    damping: np.ndarray        # (t,) passive damper gain
    springlength: np.ndarray   # (t,) spring rest length

    def length(self, q):
        """Tendon lengths (..., t) from joint positions (..., n)."""
        return q @ self.coef.T

    def velocity(self, qd):
        """Tendon length rates (..., t) from joint velocities (..., n)."""
        return qd @ self.coef.T

    def passive_force(self, q, qd):
        """Scalar passive tendon forces (..., t): the spring toward
        ``springlength`` plus the damper on L̇ (MuJoCo's passive tendon
        force, positive = pulling the length down)."""
        return -(self.stiffness * (self.length(q) - self.springlength)
                 + self.damping * self.velocity(qd))

    def passive_torque(self, q, qd):
        """Generalized passive forces (..., n): ``passive_force @ coef``
        — add to τ before stepping. Works on NumPy arrays."""
        return self.passive_force(q, qd) @ self.coef

    @property
    def limited(self) -> np.ndarray:
        """(t,) bool — which tendons carry a finite range."""
        return np.isfinite(self.lo) | np.isfinite(self.hi)

    def stepper_rows(self):
        """``(coef, lo, hi)`` restricted to the limited tendons — the
        fixed-base steppers' ``tendons=`` argument (see
        the JAX package's ``ops/contact.py``). None when no tendon has a
        range."""
        m = self.limited
        if not m.any():
            return None
        return self.coef[m], self.lo[m], self.hi[m]


def mjcf_tendons(source: str) -> MjcfTendons:
    """Extract the document's ``<tendon>`` block (fixed tendons only) —
    length couplings, ranges, and passive spring/damper parameters over
    the moving-joint ordering of :func:`parse_mjcf`."""
    desc, _, extras = _parse_mjcf_impl(source)
    ts = extras["tendons"]
    return MjcfTendons(
        n=desc.n,
        names=tuple(t["name"] for t in ts),
        coef=(np.stack([t["coef"] for t in ts])
              if ts else np.zeros((0, desc.n))),
        lo=np.array([t["lo"] for t in ts], dtype=np.float64),
        hi=np.array([t["hi"] for t in ts], dtype=np.float64),
        stiffness=np.array([t["stiffness"] for t in ts], dtype=np.float64),
        damping=np.array([t["damping"] for t in ts], dtype=np.float64),
        springlength=np.array([t["springlength"] for t in ts],
                              dtype=np.float64),
    )


class MjcfSensor(NamedTuple):
    """One ``<sensor>`` row, unresolved: ``obj`` names a site, joint,
    body, or actuator in the same document (``objtype`` says which).
    Resolve against :func:`mjcf_sites` / :func:`mjcf_bodies` /
    :func:`mjcf_actuators` (the JAX package's env layer does this; the
    port has no env layer yet)."""
    kind: str        # jointpos|jointvel|gyro|accelerometer|velocimeter|
                     # touch|framepos|framequat|framelinvel|frameangvel|
                     # actuatorfrc|tendonpos|tendonvel
    name: str
    obj: str
    objtype: str     # 'site' | 'joint' | 'body' | 'actuator' | 'tendon'


def mjcf_sensors(source: str) -> "tuple[MjcfSensor, ...]":
    """Extract the document's ``<sensor>`` block (MuJoCo's observation
    idiom — IMUs, touch sensors, joint encoders, frame trackers) as
    unresolved rows in document order."""
    _, _, extras = _parse_mjcf_impl(source)
    return tuple(MjcfSensor(s["kind"], s["name"], s["obj"], s["objtype"])
                 for s in extras["sensors"])


def mjcf_bodies(source: str) -> "dict[str, MjcfSite]":
    """Named ``<body>`` frames re-expressed like :func:`mjcf_sites`:
    body name → (governing moving link | -1 base, frame pose in that
    link's coordinates) — the resolution table for ``<framepos
    objtype="body">``-style sensors."""
    _, _, extras = _parse_mjcf_impl(source)
    return {name: MjcfSite(link, T[:3, 3].copy(), T[:3, :3].copy())
            for name, (link, T) in extras["bodies"].items()}


def _geom_endpoints(geom, defaults, compiler):
    """Collision endpoints of a sphere/capsule geom in its owner frame:
    (a (3,), b (3,), r) or None for non-capsule types / contactless
    geoms (contype == conaffinity == 0, MuJoCo's visual-only idiom)."""
    gtype = _attr(geom, defaults, "type", "sphere")
    if gtype not in ("sphere", "capsule"):
        return None
    if (int(float(_attr(geom, defaults, "contype", "1"))) == 0
            and int(float(_attr(geom, defaults, "conaffinity", "1"))) == 0):
        return None
    size_s = _attr(geom, defaults, "size")
    size = _floats(size_s) if size_s is not None else np.zeros(1)
    r = float(size[0])
    fromto = _attr(geom, defaults, "fromto")
    if fromto is not None:
        ft = _floats(fromto)
        return ft[:3], ft[3:], r
    T = _pose(geom, defaults, compiler)
    p, z = T[:3, 3], T[:3, 2]
    if gtype == "sphere":
        return p, p.copy(), r
    h = float(size[1]) if size.shape[0] > 1 else 0.0
    return p - h * z, p + h * z, r


def mjcf_collision_model(source: str, dtype=torch.float32,
                         min_separation: int = 2, obs_pairs=None,
                         base_geoms: str = "link", device="cuda"):
    """Extract the MJCF document's sphere/capsule collision geometry into a
    :class:`~..ops.collision.CollisionModel` expressed in the parsed
    description's moving-link frames, as tensors in ``dtype`` on
    ``device`` (the card unless the caller names another): body geoms ride
    their governing moving link (welded bodies' geoms are re-expressed
    through the fixed transform), worldbody geoms become static obstacles.
    Candidate pairs default to :func:`~..ops.collision.auto_pairs` over the
    kinematic tree plus the full geom×obstacle product. Box / cylinder /
    ellipsoid / plane / mesh geoms and visual-only geoms (``contype="0"
    conaffinity="0"``) are skipped — the contact layer's primitives are
    capsules and spheres (flat ground goes through ``ground_z`` /
    ``terrain=`` on the steppers instead of a plane geom).

    ``base_geoms``: where geoms on jointless bodies welded to the ROOT go
    (the MuJoCo quadruped-torso idiom — a free body expressed without a
    ``<freejoint>``, floated later by ``free_flyer_model``):
    ``"link"`` (default) emits them as base-attached geoms (link -1,
    free-flyer entry points only), ``"obstacle"`` pins them static at
    their parsed world pose (the fixed-base reading).

    Returns ``(desc, collision_model)``; ``collision_model`` is ``None``
    when the document has no collidable capsule/sphere geoms."""
    from ..ops.collision import (make_collision_model, make_geoms,
                                 make_obstacles)

    if base_geoms not in ("link", "obstacle"):
        raise ValueError('base_geoms must be "link" or "obstacle", got '
                         f"{base_geoms!r}")
    desc, records, _ = _parse_mjcf_impl(source)
    links, ga, gb, gr = [], [], [], []
    oa, ob, orr = [], [], []
    for link_idx, T, ends in records:
        R, p = T[:3, :3], T[:3, 3]
        a, b, r = R @ ends[0] + p, R @ ends[1] + p, ends[2]
        if link_idx == -2 or (link_idx == -1 and base_geoms == "obstacle"):
            oa.append(a)
            ob.append(b)
            orr.append(r)
        else:
            links.append(link_idx)
            ga.append(a)
            gb.append(b)
            gr.append(r)
    if not links:
        return desc, None
    geoms = make_geoms(links, np.stack(ga), np.stack(gb), np.asarray(gr),
                       dtype=dtype, device=device)
    obstacles = None
    if oa:
        obstacles = make_obstacles(np.stack(oa), np.stack(ob),
                                   np.asarray(orr), dtype=dtype,
                                   device=device)
    cm = make_collision_model(geoms, topology=desc.topology,
                              obstacles=obstacles, obs_pairs=obs_pairs,
                              min_separation=min_separation)
    return desc, cm


def _parse_mjcf_impl(source: str):
    text = source
    if "<" not in source:
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "mujoco":
        raise ValueError("not an MJCF document (missing <mujoco> root)")
    name = root.get("model", "robot")
    comp_el = root.find("compiler")
    compiler = dict(angle="degree", eulerseq="xyz", inertiafromgeom="auto")
    if comp_el is not None:
        for key in compiler:
            if comp_el.get(key) is not None:
                compiler[key] = comp_el.get(key)
        if comp_el.get("coordinate", "local") != "local":
            raise NotImplementedError(
                'coordinate="global" MJCF is not supported (removed from '
                "modern MuJoCo; convert with the MuJoCo compiler first)")
    if root.find("include") is not None:
        raise NotImplementedError(
            "<include> is not supported — inline the included files")
    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF document has no <worldbody>")
    defaults_table = _collect_defaults(root)
    to_rad = np.pi / 180.0 if compiler["angle"] == "degree" else 1.0

    ordered: list[dict] = []      # emitted moving joints
    parent_of: list[int] = []
    moving_link: list[str] = []
    inertias: list[np.ndarray] = []
    base_inertia = np.zeros((6, 6))
    geom_records: list[tuple] = []   # (link_idx | -1, T_owner→frame, ends)
    site_records: list[tuple] = []   # (name, link_idx | -1 | -2, T_site)
    body_frames: dict = {}           # body name → (link_idx | -1, T_body)

    def record_geoms(body, link_idx, T, cls):
        for geom in body.findall("geom"):
            d = _defaults_for(defaults_table, "geom",
                              geom.get("class", cls))
            ends = _geom_endpoints(geom, d, compiler)
            if ends is not None:
                geom_records.append((link_idx, T, ends))
        for site in body.findall("site"):
            d = _defaults_for(defaults_table, "site",
                              site.get("class", cls))
            site_records.append(
                (site.get("name", f"site{len(site_records)}"), link_idx,
                 T @ _pose(site, d, compiler)))

    def joint_spec(jel, cls, body_name, freejoint=False):
        if freejoint:
            d = {}
            jtype = "free"
        else:
            d = _defaults_for(defaults_table, "joint",
                              jel.get("class", cls))
            jtype = _attr(jel, d, "type", "hinge")
        if jtype not in _JOINT_TYPES:
            raise NotImplementedError(f"joint type {jtype!r} not supported")
        pos = _attr(jel, d, "pos")
        axis = _attr(jel, d, "axis")
        lo, hi, eff = -_INF, _INF, _INF
        rng = _attr(jel, d, "range")
        limited = _attr(jel, d, "limited", "auto")
        if rng is not None and limited in ("auto", "true") \
                and jtype in ("hinge", "slide"):
            vals = _floats(rng)
            scale = to_rad if jtype == "hinge" else 1.0
            if not (vals[0] == 0.0 and vals[1] == 0.0):
                lo, hi = vals[0] * scale, vals[1] * scale
        frc = _attr(jel, d, "actuatorfrcrange")
        if frc is not None:
            vals = _floats(frc)
            eff = max(abs(vals[0]), abs(vals[1]))
        return dict(
            name=jel.get("name", f"{body_name}_joint"),
            type=_JOINT_TYPES[jtype],
            anchor=_floats(pos) if pos is not None else np.zeros(3),
            axis=(_floats(axis) if axis is not None
                  else np.array([0.0, 0.0, 1.0])),
            damping=float(_attr(jel, d, "damping", "0")),
            armature=float(_attr(jel, d, "armature", "0")),
            frictionloss=float(_attr(jel, d, "frictionloss", "0")),
            lower=lo, upper=hi, effort=eff,
        )

    def visit(body, parent_idx, T_acc, cls):
        """``T_acc``: pose of ``body``'s PARENT frame in the frame of its
        governing moving link (identity unless jointless bodies
        intervened). Emits this body's joints, attaches its inertia, and
        recurses."""
        nonlocal base_inertia
        body_name = body.get("name", f"body{len(moving_link)}")
        cls = body.get("childclass", cls)
        T_pb = T_acc @ _pose(body, {}, compiler)
        I6 = _body_inertial(body, defaults_table, compiler, cls)

        specs = []
        for child in body:
            if child.tag == "joint":
                specs.append(joint_spec(child, cls, body_name))
            elif child.tag == "freejoint":
                specs.append(joint_spec(child, cls, body_name,
                                        freejoint=True))
        if any(s["type"] == "floating" for s in specs) and len(specs) > 1:
            raise ValueError(
                f"body {body_name!r}: a free joint cannot be combined "
                "with other joints")

        if not specs:
            # jointless body: weld into the governing link (or the world)
            I_target = transform_spatial_inertia(I6, T_pb[:3, :3],
                                                 T_pb[:3, 3])
            if parent_idx < 0:
                base_inertia += I_target
            else:
                inertias[parent_idx] = inertias[parent_idx] + I_target
            body_frames[body_name] = (parent_idx, T_pb)
            record_geoms(body, parent_idx, T_pb, cls)
            for sub in body.findall("body"):
                visit(sub, parent_idx, T_pb, cls)
            return

        # chain of joints, document order = outermost first (MuJoCo's
        # anchor-preserving local post-multiplication); intermediate
        # links are massless, the body inertia lands on the last one
        prev_anchor = None
        idx = parent_idx
        for si, s in enumerate(specs):
            if prev_anchor is None:
                T_origin = T_pb @ homogeneous(np.eye(3), s["anchor"])
            else:
                T_origin = homogeneous(np.eye(3), s["anchor"] - prev_anchor)
            ordered.append(dict(s, T_origin=T_origin))
            parent_of.append(idx)
            idx = len(ordered) - 1
            last = si == len(specs) - 1
            moving_link.append(body_name if last
                               else f"{body_name}__chain{si}")
            if last:
                # body inertia in the link frame (body axes, origin at
                # the last joint's anchor)
                inertias.append(transform_spatial_inertia(
                    I6, np.eye(3), -s["anchor"]))
            else:
                inertias.append(np.zeros((6, 6)))
            prev_anchor = s["anchor"]
        # children see the body frame: undo the final anchor shift
        T_body_in_link = homogeneous(np.eye(3), -prev_anchor)
        body_frames[body_name] = (idx, T_body_in_link)
        record_geoms(body, idx, T_body_in_link, cls)
        for sub in body.findall("body"):
            visit(sub, idx, T_body_in_link, cls)

    for body in worldbody.findall("body"):
        visit(body, -1, np.eye(4), "main")
    # static worldbody geoms contribute nothing to the dynamics — they are
    # collision obstacles (recorded below, sentinel -2), like URDF's world
    # link. (Geoms on jointless bodies welded to the root keep -1: they
    # ride the base when the description is promoted to a free flyer.)
    record_geoms(worldbody, -2, np.eye(4), "main")

    n = len(ordered)
    if n == 0:
        raise ValueError("MJCF model has no joints")

    topo = Topology(
        parents=tuple(parent_of),
        joint_names=tuple(j["name"] for j in ordered),
        link_names=tuple(moving_link),
    )
    origin_R = np.stack([j["T_origin"][:3, :3] for j in ordered])
    axis = np.stack([j["axis"] / np.linalg.norm(j["axis"])
                     for j in ordered])

    # <equality> block: <joint> (linear polycoef) → mimic couplings, and
    # <connect> → loop-closure cuts. Evaluated here because it needs the
    # moving-joint ordering and the zero-configuration link poses (MuJoCo
    # derives body2's local anchor at qpos0; same convention here).
    mimics: list[tuple] = []
    connects: list[tuple] = []
    welds: list[tuple] = []
    eq_el = root.find("equality")
    if eq_el is not None:
        name_to_idx = {j["name"]: i for i, j in enumerate(ordered)}
        # zero-config world pose of every moving link: joint motion is
        # identity at q = 0, so poses chain the joint origins alone
        L = []
        for i in range(n):
            pi = parent_of[i]
            Li = (L[pi] if pi >= 0 else np.eye(4)) @ ordered[i]["T_origin"]
            L.append(Li)

        def world_T(link, T_local):
            return (L[link] if link >= 0 else np.eye(4)) @ T_local

        site_map = {nm: (l, T) for nm, l, T in site_records}
        for e in eq_el:
            d = _defaults_for(defaults_table, e.tag, e.get("class", "main"))
            if e.tag == "joint":
                j1 = _attr(e, d, "joint1")
                j2 = _attr(e, d, "joint2")
                if j1 not in name_to_idx or (j2 is not None
                                             and j2 not in name_to_idx):
                    raise ValueError(
                        f"equality joint constraint references unknown "
                        f"joint ({j1!r}, {j2!r})")
                if j2 is None:
                    raise NotImplementedError(
                        "single-joint equality (lock to a constant) is "
                        "not supported — fix the joint or use limits")
                poly = _floats(_attr(e, d, "polycoef", "0 1 0 0 0"))
                if np.any(poly[2:] != 0.0):
                    raise NotImplementedError(
                        "nonlinear polycoef joint couplings are not "
                        "supported (linear a0 + a1*q only)")
                mimics.append((name_to_idx[j1], name_to_idx[j2],
                               float(poly[1]), float(poly[0])))
            elif e.tag == "connect":
                s1 = _attr(e, d, "site1")
                if s1 is not None:
                    s2 = _attr(e, d, "site2")
                    if s1 not in site_map or s2 not in site_map:
                        raise ValueError(
                            f"connect references unknown site "
                            f"({s1!r}, {s2!r})")
                    l1, T1 = site_map[s1]
                    l2, T2 = site_map[s2]
                    if l1 == -2 or l2 == -2:   # worldbody site = world pin
                        if l1 == -2:
                            (l1, T1), (l2, T2) = (l2, T2), (l1, T1)
                    o1, o2 = T1[:3, 3], T2[:3, 3]
                else:
                    b1 = _attr(e, d, "body1")
                    b2 = _attr(e, d, "body2")
                    anchor = _floats(_attr(e, d, "anchor", "0 0 0"))
                    if b1 not in body_frames:
                        raise ValueError(f"connect references unknown "
                                         f"body {b1!r}")
                    l1, T1 = body_frames[b1]
                    o1 = (T1 @ np.append(anchor, 1.0))[:3]
                    w = (world_T(l1, T1) @ np.append(anchor, 1.0))[:3]
                    if b2 is None or b2 == "world":
                        l2, o2 = -2, w          # world pin at the anchor
                    else:
                        if b2 not in body_frames:
                            raise ValueError(f"connect references unknown "
                                             f"body {b2!r}")
                        l2, T2 = body_frames[b2]
                        # body2's local point: the SAME world point at q=0
                        W2 = world_T(l2, T2)
                        o2 = (np.linalg.inv(W2) @ np.append(w, 1.0))[:3]
                connects.append((int(l1), np.asarray(o1, np.float64),
                                 int(l2), np.asarray(o2, np.float64)))
            elif e.tag == "weld":
                # 6-row bilateral: the anchor's 3 connect rows plus 3
                # orientation rows pinning the qpos0 relative rotation
                # (MuJoCo's <weld> with the default relpose sentinel)
                b1 = _attr(e, d, "body1")
                b2 = _attr(e, d, "body2")
                if b1 is None:
                    raise ValueError("<weld> needs body1")
                relpose = _attr(e, d, "relpose")
                if relpose is not None and np.any(
                        _floats(relpose)[3:] != 0.0):
                    raise NotImplementedError(
                        "<weld relpose=> with an explicit (nonzero) "
                        "quaternion is not supported — the all-zero "
                        "quaternion sentinel (qpos0 relative pose, "
                        "MuJoCo's default) only")
                anchor = _floats(_attr(e, d, "anchor", "0 0 0"))
                if b1 not in body_frames:
                    raise ValueError(f"weld references unknown body "
                                     f"{b1!r}")
                l1, T1 = body_frames[b1]
                o1 = (T1 @ np.append(anchor, 1.0))[:3]
                w = (world_T(l1, T1) @ np.append(anchor, 1.0))[:3]
                R1 = world_T(l1, np.eye(4))[:3, :3]   # link rotation @ q0
                if b2 is None or b2 == "world":
                    l2, o2 = -2, w
                    R0 = R1.T
                else:
                    if b2 not in body_frames:
                        raise ValueError(f"weld references unknown body "
                                         f"{b2!r}")
                    l2, T2 = body_frames[b2]
                    W2 = world_T(l2, T2)
                    o2 = (np.linalg.inv(W2) @ np.append(w, 1.0))[:3]
                    R0 = R1.T @ world_T(l2, np.eye(4))[:3, :3]
                welds.append((int(l1), np.asarray(o1, np.float64),
                              int(l2), np.asarray(o2, np.float64),
                              np.asarray(R0, np.float64)))
            else:
                raise NotImplementedError(
                    f"equality constraint <{e.tag}> is not supported "
                    "(joint couplings, connect cuts, and welds only)")

    desc = RobotDescription(
        name=name, topology=topo,
        joint_types=tuple(j["type"] for j in ordered),
        origin_xyz=np.stack([j["T_origin"][:3, 3] for j in ordered]),
        origin_rpy=np.stack([_matrix_to_rpy(R) for R in origin_R]),
        axis=axis,
        damping=np.array([j["damping"] for j in ordered]),
        inertia=np.stack(inertias),
        base_inertia=base_inertia,
        q_lower=np.array([j["lower"] for j in ordered]),
        q_upper=np.array([j["upper"] for j in ordered]),
        effort=np.array([j["effort"] for j in ordered]),
        velocity=np.full(n, _INF),
        armature=np.array([j["armature"] for j in ordered]),
        frictionloss=np.array([j["frictionloss"] for j in ordered]),
        mimic=tuple(mimics),
    )

    # <tendon> block: <fixed> length couplings L = Σ coef_j·q_j over
    # scalar (hinge/slide) joints — MuJoCo's differential/coupling
    # transmission idiom. Parsed before <actuator> because tendon-
    # transmission actuators reference these rows by name.
    tendons: list[dict] = []
    tend_el = root.find("tendon")
    if tend_el is not None:
        name_to_idx = {j["name"]: i for i, j in enumerate(ordered)}
        for t in tend_el:
            if t.tag != "fixed":
                raise NotImplementedError(
                    f"tendon type <{t.tag}> is not supported — fixed "
                    "(joint-space) tendons only; spatial wrapping tendons "
                    "have no closed-form joint-space Jacobian")
            d = _defaults_for(defaults_table, "tendon",
                              t.get("class", "main"))
            # raise-on-unsupported policy (matching the rest of this
            # parser): attributes this front-end consumes nowhere must not
            # silently drop — a tendon relying on dry friction would
            # otherwise simulate without it, no diagnostic (ADVICE r4).
            # frictionloss/armature change dynamics whenever nonzero;
            # the limit-solver attributes (margin, solreflimit/solimplimit)
            # only act on an ACTIVE range constraint — a tendon without a
            # usable range ignores them in MuJoCo too, and a <default>
            # class restating solref-style defaults must not poison
            # unlimited tendons (r5 review).
            has_range = (_attr(t, d, "range") is not None
                         or _attr(t, d, "limited", "auto") == "true")
            unsupported = ["frictionloss", "armature"]
            if has_range:
                unsupported += ["margin", "solreflimit", "solimplimit"]
            for attr in unsupported:
                val = _attr(t, d, attr)
                if val is not None and any(float(v) != 0.0
                                           for v in _floats(val)):
                    raise NotImplementedError(
                        f"tendon {t.get('name', '?')!r}: attribute "
                        f"{attr}={val!r} is not supported by this "
                        "front-end (fixed tendons carry stiffness/"
                        "damping/springlength/range only)")
            coef = np.zeros(n)
            seen_joints: set = set()
            for jc in t:
                if jc.tag != "joint":
                    raise NotImplementedError(
                        f"<fixed> tendon child <{jc.tag}> is not "
                        "supported (<joint joint= coef=> rows only)")
                jn = jc.get("joint")
                if jn not in name_to_idx:
                    raise ValueError(
                        f"tendon {t.get('name', '?')!r} references "
                        f"unknown joint {jn!r}")
                ji = name_to_idx[jn]
                if ordered[ji]["type"] in ("spherical", "floating"):
                    raise ValueError(
                        f"tendon {t.get('name', '?')!r}: fixed tendons "
                        "couple scalar (hinge/slide) joints only — "
                        f"joint {jn!r} is {ordered[ji]['type']}")
                if ji in seen_joints:
                    # MuJoCo errors on a duplicated <joint> row inside one
                    # tendon; accumulating coefficients would silently
                    # diverge from it (ADVICE r4)
                    raise ValueError(
                        f"tendon {t.get('name', '?')!r} references joint "
                        f"{jn!r} more than once")
                seen_joints.add(ji)
                coef[ji] += float(jc.get("coef", "1"))
            t_lo, t_hi = -_INF, _INF
            rng_s = _attr(t, d, "range")
            limited = _attr(t, d, "limited", "auto")
            if limited == "true" and (
                    rng_s is None
                    or tuple(_floats(rng_s)[:2]) == (0.0, 0.0)):
                # MuJoCo compile error; silently-unlimited diverges (ADVICE)
                raise ValueError(
                    f"tendon {t.get('name', '?')!r}: limited=\"true\" "
                    "requires a usable range attribute")
            if rng_s is not None and limited in ("auto", "true"):
                vals = _floats(rng_s)
                if not (vals[0] == 0.0 and vals[1] == 0.0):
                    t_lo, t_hi = float(vals[0]), float(vals[1])
            sl_s = _attr(t, d, "springlength")
            # MuJoCo's default springlength (-1 sentinel) means "the
            # length at qpos0"; qpos0 IS q = 0 in this front-end, where
            # every fixed tendon has L(0) = 0 — so both the sentinel and
            # a missing attribute resolve to 0. An explicit non-negative
            # value is taken literally (first value; the two-value
            # deadband form is not supported).
            springlength = 0.0
            if sl_s is not None:
                vals = _floats(sl_s)
                if vals.shape[0] > 1 and vals[0] != vals[1]:
                    raise NotImplementedError(
                        "tendon springlength deadband (two distinct "
                        "values) is not supported")
                if vals[0] >= 0.0:
                    springlength = float(vals[0])
                elif vals[0] != -1.0:
                    # only MuJoCo's exact −1 sentinel means "length at
                    # qpos0"; any other negative is a model bug MuJoCo
                    # rejects at compile time (ADVICE r4)
                    raise ValueError(
                        f"tendon {t.get('name', '?')!r}: springlength="
                        f"{vals[0]} — negative lengths are invalid "
                        "(only the -1 sentinel is accepted)")
            tendons.append(dict(
                name=t.get("name", f"tendon{len(tendons)}"), coef=coef,
                lo=t_lo, hi=t_hi,
                stiffness=float(_attr(t, d, "stiffness", "0")),
                damping=float(_attr(t, d, "damping", "0")),
                springlength=springlength))
    tendon_names = {t["name"]: i for i, t in enumerate(tendons)}

    # <actuator> block: motor/general with joint or fixed-tendon
    # transmission → per-row (joint index | tendon index, gear,
    # ctrlrange) plus the gear-scaled transmission (moment) row over the
    # moving joints. Evaluated here because the moving-joint ordering is
    # only known after the tree walk.
    acts: list[dict] = []
    act_el = root.find("actuator")
    if act_el is not None:
        name_to_idx = {j["name"]: i for i, j in enumerate(ordered)}
        for a in act_el:
            if a.tag not in ("motor", "general", "position", "velocity"):
                raise NotImplementedError(
                    f"actuator type <{a.tag}> is not supported (motor / "
                    "torque-mode general / position / velocity; convert "
                    "other servos to explicit laws — see contact.pd_torque)")
            d = _defaults_for(defaults_table, a.tag, a.get("class", "main"))
            jn = _attr(a, d, "joint")
            tn = _attr(a, d, "tendon")
            if jn is None and tn is None:
                raise NotImplementedError(
                    f"actuator {a.get('name', '?')!r}: only joint and "
                    "fixed-tendon transmissions are supported (site/body "
                    "are not)")
            if jn is not None and tn is not None:
                raise ValueError(f"actuator {a.get('name', '?')!r} names "
                                 "both a joint and a tendon")
            if jn is not None and jn not in name_to_idx:
                raise ValueError(f"actuator {a.get('name', '?')!r} targets "
                                 f"unknown joint {jn!r}")
            if tn is not None and tn not in tendon_names:
                raise ValueError(f"actuator {a.get('name', '?')!r} targets "
                                 f"unknown tendon {tn!r}")
            gear = _floats(_attr(a, d, "gear", "1"))
            if gear.shape[0] != 1:
                raise NotImplementedError(
                    "multi-component gear vectors are not supported for "
                    "joint-transmission actuators")
            cr = _attr(a, d, "ctrlrange")
            limited = _attr(a, d, "ctrllimited", "auto")
            lo, hi = -_INF, _INF
            if cr is not None and limited in ("auto", "true"):
                vals = _floats(cr)
                if not (vals[0] == 0.0 and vals[1] == 0.0):
                    lo, hi = float(vals[0]), float(vals[1])
            # servo gains (MuJoCo's affine actuator model: force =
            # gain·ctrl + bias; position → gain kp, bias (−kp·len,
            # −kv·vel); velocity → gain kv, bias −kv·vel)
            kp = float(_attr(a, d, "kp", "1"))
            kv_def = "1" if a.tag == "velocity" else "0"
            kv = float(_attr(a, d, "kv", kv_def))
            flo, fhi = -_INF, _INF
            fr = _attr(a, d, "forcerange")
            flimited = _attr(a, d, "forcelimited", "auto")
            if fr is not None and flimited in ("auto", "true"):
                vals = _floats(fr)
                if not (vals[0] == 0.0 and vals[1] == 0.0):
                    flo, fhi = float(vals[0]), float(vals[1])
            # the gear-scaled transmission row over the moving joints:
            # actuator length = moment · q, applied torque = force · moment
            # (a joint actuator's row is gear·e_j; a tendon actuator's is
            # gear·coef — MuJoCo's mjData.actuator_moment for these
            # transmission types)
            moment = np.zeros(n)
            if jn is not None:
                jidx, tidx = name_to_idx[jn], -1
                moment[jidx] = float(gear[0])
            else:
                jidx, tidx = -1, tendon_names[tn]
                moment = float(gear[0]) * tendons[tidx]["coef"]
            acts.append(dict(name=a.get("name", jn or tn), kind=a.tag,
                             joint=jidx, tendon=tidx, moment=moment,
                             gear=float(gear[0]),
                             lo=lo, hi=hi, kp=kp, kv=kv, flo=flo, fhi=fhi))

    # <sensor> block → raw rows; resolution against the parsed frames
    # happens in mjcf_sensors / the env layer (which owns the fb-vs-md
    # coordinate mapping)
    sensors: list[dict] = []
    sens_el = root.find("sensor")
    if sens_el is not None:
        for s in sens_el:
            tag = s.tag
            if tag in ("jointpos", "jointvel"):
                obj, objtype = s.get("joint"), "joint"
            elif tag in ("gyro", "accelerometer", "velocimeter", "touch"):
                obj, objtype = s.get("site"), "site"
            elif tag in ("framepos", "framequat", "framelinvel",
                         "frameangvel"):
                objtype = s.get("objtype", "site")
                obj = s.get("objname")
                if objtype not in ("site", "body"):
                    raise NotImplementedError(
                        f"<{tag} objtype={objtype!r}> — site and body "
                        "frames only")
            elif tag == "actuatorfrc":
                obj, objtype = s.get("actuator"), "actuator"
            elif tag in ("tendonpos", "tendonvel"):
                obj, objtype = s.get("tendon"), "tendon"
            else:
                raise NotImplementedError(
                    f"sensor type <{tag}> is not supported (jointpos / "
                    "jointvel / gyro / accelerometer / velocimeter / "
                    "touch / framepos / framequat / framelinvel / "
                    "frameangvel / actuatorfrc / tendonpos / tendonvel)")
            if obj is None:
                raise ValueError(f"<{tag}> sensor names no target object")
            sensors.append(dict(
                kind=tag, obj=obj, objtype=objtype,
                name=s.get("name", f"{tag}_{obj}_{len(sensors)}")))

    return desc, geom_records, dict(sites=site_records, actuators=acts,
                                    connects=connects, welds=welds,
                                    sensors=sensors, tendons=tendons,
                                    bodies=dict(body_frames))
