"""Plain rigid-body dynamics of one state, the benchmark's reference.

A URDF reader and the recursive Newton-Euler inverse dynamics, the
composite-rigid-body mass matrix and forward dynamics by a linear solve,
written as plain torch operations on one state, vectorised over states by
``torch.func.vmap``: the derivatives the entries return are taken here by
reverse-mode automatic differentiation (``torch.autograd.grad`` over the
vectorised call), not by the analytic recursions of the program under
test. Nothing here imports that program.

Conventions (Featherstone): a motion vector is [ω; v]; joint i's transform
X_i maps its parent's coordinates to its own, X = [[E, 0], [−E·p̂, E]] with
E the parent→child rotation transposed and p the joint origin in the parent;
gravity enters as the base acceleration [0, 0, 0, 0, 0, −g], g = −9.81.
Viscous damping adds damping·q̇ to the torque and the armature adds
armature·q̈ (the mass matrix's diagonal).

``tf32=True`` rounds both operands of every matrix product to TF32 (10
explicit mantissa bits, round to nearest even) as a tensor core does, and
computes in float32: the benchmark's control, one precision step below the
float32 the configurations state.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


# ---------------------------------------------------------------- the robot
@dataclass(frozen=True)
class Robot:
    """A fixed-base tree of single-dof joints, topologically ordered
    (parents before children, depth first in document order), fixed joints
    merged into their moving parents."""

    name: str
    parents: tuple[int, ...]
    prismatic: tuple[bool, ...]
    axis: np.ndarray       # (n, 3) unit joint axes in the joint frame
    rot: np.ndarray        # (n, 3, 3) joint origin rotation in the parent
    xyz: np.ndarray        # (n, 3) joint origin in the parent
    inertia: np.ndarray    # (n, 6, 6) spatial inertia of each moving link
    damping: np.ndarray    # (n,)
    armature: np.ndarray   # (n,)

    @property
    def n(self) -> int:
        return len(self.parents)


def _vec(text, default):
    return np.array([float(s) for s in text.split()]) if text else default


def _rpy(rpy) -> np.ndarray:
    """R = Rz(yaw)·Ry(pitch)·Rx(roll)."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p),
                              math.sin(p), math.cos(y), math.sin(y))
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _hat(v) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _origin(el):
    o = el.find("origin")
    if o is None:
        return np.zeros(3), np.zeros(3)
    return _vec(o.get("xyz"), np.zeros(3)), _vec(o.get("rpy"), np.zeros(3))


def _motion_xform(R, p) -> np.ndarray:
    """X from a frame at pose (R, p) in its parent: parent → frame."""
    E = R.T
    X = np.zeros((6, 6))
    X[:3, :3] = X[3:, 3:] = E
    X[3:, :3] = -E @ _hat(p)
    return X


def _link_inertia(link) -> np.ndarray:
    """The link's spatial inertia in its own frame."""
    el = link.find("inertial")
    if el is None:
        return np.zeros((6, 6))
    m = float(el.find("mass").get("value"))
    com, rpy = _origin(el)
    t = el.find("inertia")
    g = {k: float(t.get(k, 0.0)) for k in
         ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
    Ic = np.array([[g["ixx"], g["ixy"], g["ixz"]],
                   [g["ixy"], g["iyy"], g["iyz"]],
                   [g["ixz"], g["iyz"], g["izz"]]])
    R = _rpy(rpy)
    C = _hat(com)
    I6 = np.zeros((6, 6))
    I6[:3, :3] = R @ Ic @ R.T + m * C @ C.T
    I6[:3, 3:] = m * C
    I6[3:, :3] = m * C.T
    I6[3:, 3:] = m * np.eye(3)
    return I6


def read_urdf(path) -> Robot:
    """Read a URDF file of revolute, continuous, prismatic and fixed
    joints."""
    root = ET.fromstring(Path(path).read_text())
    links = {ln.get("name"): ln for ln in root.findall("link")}
    inertia = {name: _link_inertia(el) for name, el in links.items()}
    children: dict[str, list] = {}
    child_links = set()
    for j in root.findall("joint"):
        kind = j.get("type")
        if kind not in ("revolute", "continuous", "prismatic", "fixed"):
            raise ValueError(f"joint type {kind!r} is not a single-dof joint")
        children.setdefault(j.find("parent").get("link"), []).append(j)
        child_links.add(j.find("child").get("link"))
    (base,) = [name for name in links if name not in child_links]

    joints, parents, moving = [], [], []

    def visit(link, parent, T):
        for j in children.get(link, ()):
            xyz, rpy = _origin(j)
            Tj = T @ np.block([[_rpy(rpy), xyz[:, None]],
                               [np.zeros((1, 3)), np.ones((1, 1))]])
            child = j.find("child").get("link")
            if j.get("type") == "fixed":
                # lump the child's inertia into the governing moving link
                X = _motion_xform(Tj[:3, :3], Tj[:3, 3])
                owner = moving[parent] if parent >= 0 else base
                inertia[owner] = inertia[owner] + X.T @ inertia[child] @ X
                visit(child, parent, Tj)
                continue
            dyn = j.find("dynamics")
            attr = (lambda k: float(dyn.get(k)) if dyn is not None
                    and dyn.get(k) else 0.0)
            ax = j.find("axis")
            axis = _vec(ax.get("xyz") if ax is not None else None,
                        np.array([0.0, 0.0, 1.0]))
            joints.append(dict(prismatic=j.get("type") == "prismatic",
                               axis=axis / np.linalg.norm(axis),
                               rot=Tj[:3, :3], xyz=Tj[:3, 3],
                               damping=attr("damping"),
                               armature=attr("armature")))
            parents.append(parent)
            moving.append(child)
            visit(child, len(joints) - 1, np.eye(4))

    visit(base, -1, np.eye(4))
    return Robot(
        name=root.get("name", "robot"), parents=tuple(parents),
        prismatic=tuple(j["prismatic"] for j in joints),
        axis=np.stack([j["axis"] for j in joints]),
        rot=np.stack([j["rot"] for j in joints]),
        xyz=np.stack([j["xyz"] for j in joints]),
        inertia=np.stack([inertia[name] for name in moving]),
        damping=np.array([j["damping"] for j in joints]),
        armature=np.array([j["armature"] for j in joints]))


# ------------------------------------------------------------ the dynamics
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32: 10 explicit mantissa bits, to nearest,
    ties to even. Arithmetic on the value (no reinterpretation of its bits,
    which ``vmap`` cannot batch): the unit in TF32's last place from the
    float64 exponent, and ``round`` (half to even) in that unit."""
    x64 = x.double()
    ulp = torch.exp2(torch.floor(torch.log2(x64.abs())) - 10)
    r = torch.round(x64 / ulp) * ulp
    return torch.where(x == 0, x, r.to(x.dtype))


class Dynamics:
    """The dynamics of one state of ``robot``; q, q̇, q̈, u are (n,)
    tensors. Vectorise over states with ``torch.func.vmap``."""

    def __init__(self, robot: Robot, *, device="cpu", tf32=False):
        self.robot, self.n, self.tf32 = robot, robot.n, tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                      dtype=self.dtype, device=device)
        S = np.zeros((robot.n, 6))
        for i, (ax, pr) in enumerate(zip(robot.axis, robot.prismatic)):
            S[i, 3 * pr:3 * pr + 3] = ax
        K = np.stack([_hat(a) for a in robot.axis])
        self.S = t(S)
        self.K, self.K2 = t(K), t(K @ K)
        self.rot, self.xyz, self.axis = (t(robot.rot), t(robot.xyz),
                                         t(robot.axis))
        self.inertia = t(robot.inertia)
        self.damping, self.armature = t(robot.damping), t(robot.armature)
        self.eye3 = torch.eye(3, dtype=self.dtype, device=device)
        self.zero3 = torch.zeros((3, 3), dtype=self.dtype, device=device)
        # below[j]: 1 on rows j.. of column j of a lower triangle, else 0
        self.below = torch.ones((robot.n, robot.n), dtype=self.dtype,
                                device=device).triu()

    def mm(self, a, b):
        """a @ b for a (…, i, k) and b (…, k) or (…, k, j), on TF32-rounded
        operands in the control. Products and sums on the CUDA cores, never
        a library's matrix product (which could run in TF32 itself)."""
        if self.tf32:
            # the rounding has no derivative of its own: differentiate
            # through it as through the identity (straight through), the
            # backward pass's products on the rounded operands
            a = a + (tf32_round(a.detach()) - a).detach()
            b = b + (tf32_round(b.detach()) - b).detach()
        if b.dim() == 1:
            return (a * b).sum(-1)
        return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)

    def hat(self, v):
        z = torch.zeros_like(v[0])
        return torch.stack([torch.stack([z, -v[2], v[1]]),
                            torch.stack([v[2], z, -v[0]]),
                            torch.stack([-v[1], v[0], z])])

    def crm(self, v):
        """v× on motion vectors (6, 6)."""
        w, u = self.hat(v[:3]), self.hat(v[3:])
        return torch.cat([torch.cat([w, self.zero3], 1),
                          torch.cat([u, w], 1)], 0)

    def xform(self, i, qi):
        """X_i(q_i): parent → joint i coordinates (6, 6)."""
        if self.robot.prismatic[i]:
            R = self.rot[i]
            p = self.xyz[i] + self.mm(self.rot[i], self.axis[i] * qi)
        else:
            Rj = self.eye3 + torch.sin(qi) * self.K[i] + (
                1 - torch.cos(qi)) * self.K2[i]
            R, p = self.mm(self.rot[i], Rj), self.xyz[i]
        E = R.T
        return torch.cat([torch.cat([E, self.zero3], 1),
                          torch.cat([-self.mm(E, self.hat(p)), E], 1)], 0)

    def rnea(self, q, qd, qdd, gravity=-9.81):
        """Joint torques c(q, q̇, q̈), (n,)."""
        n, par = self.n, self.robot.parents
        X = [self.xform(i, q[i]) for i in range(n)]
        a0 = torch.tensor([0, 0, 0, 0, 0, -gravity], dtype=q.dtype,
                          device=q.device)
        v, a, f = [None] * n, [None] * n, [None] * n
        for i in range(n):
            vJ = self.S[i] * qd[i]
            if par[i] >= 0:
                vp, ap = self.mm(X[i], v[par[i]]), self.mm(X[i], a[par[i]])
            else:
                vp, ap = 0.0, self.mm(X[i], a0)
            v[i] = vp + vJ
            a[i] = ap + self.mm(self.crm(v[i]), vJ) + self.S[i] * qdd[i]
            Iv = self.mm(self.inertia[i], v[i])
            f[i] = self.mm(self.inertia[i], a[i]) - self.mm(
                self.crm(v[i]).T, Iv)
        c = [None] * n
        for i in reversed(range(n)):
            c[i] = torch.dot(self.S[i], f[i])
            if par[i] >= 0:
                f[par[i]] = f[par[i]] + self.mm(X[i].T, f[i])
        return torch.stack(c) + self.damping * qd + self.armature * qdd

    def mass(self, q):
        """The joint-space mass matrix M(q) by the composite-rigid-body
        algorithm, (n, n)."""
        n, par = self.n, self.robot.parents
        X = [self.xform(i, q[i]) for i in range(n)]
        IC = list(self.inertia.unbind(0))
        for i in reversed(range(n)):
            if par[i] >= 0:
                IC[par[i]] = IC[par[i]] + self.mm(X[i].T,
                                                  self.mm(IC[i], X[i]))
        M = [[None] * n for _ in range(n)]
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        for i in range(n):
            F = self.mm(IC[i], self.S[i])
            M[i][i] = torch.dot(self.S[i], F) + self.armature[i]
            j = i
            while par[j] >= 0:
                F = self.mm(X[j].T, F)
                j = par[j]
                M[i][j] = M[j][i] = torch.dot(self.S[j], F)
        return torch.stack([torch.stack([m if m is not None else zero
                                         for m in row]) for row in M])

    def solve(self, M, b):
        """M⁻¹·b for a symmetric positive definite M, by a Cholesky factor
        M = L·Lᵀ and two triangular solves, column by column in plain
        operations (``torch.linalg``'s solvers are not differentiated
        under ``vmap`` alike on every version)."""
        n = self.n
        cols = []   # the columns of L
        for j in range(n):
            v = M[:, j]
            if j:
                L = torch.stack(cols, dim=1)
                v = v - self.mm(L, L[j])
            cols.append(v * self.below[j] / torch.sqrt(v[j]))
        L = torch.stack(cols, dim=1)
        y = []
        for j in range(n):
            r = b[j] - torch.dot(L[j, :j], torch.stack(y)) if j else b[j]
            y.append(r / L[j, j])
        x = [None] * n
        for j in reversed(range(n)):
            r = (y[j] - torch.dot(L[j + 1:, j], torch.stack(x[j + 1:]))
                 if j < n - 1 else y[j])
            x[j] = r / L[j, j]
        return torch.stack(x)

    def fd(self, q, qd, u, gravity=-9.81):
        """q̈ = M(q)⁻¹·(u − c(q, q̇, 0)), (n,)."""
        c = self.rnea(q, qd, torch.zeros_like(q), gravity)
        return self.solve(self.mass(q), u - c)

    @staticmethod
    def jacobian_rows(fn, inputs, wrt, batched=False):
        """The Jacobian of ``fn``'s (S, m) answer to the inputs ``wrt``,
        (S, m, Σ widths): one reverse pass an answer row, over the whole
        block at once (the states are independent, so the gradient of a
        row's sum over the states is that row of each state's Jacobian).
        ``fn`` takes one state's inputs, or the block's where ``batched``."""
        with torch.enable_grad():
            x = [t.detach().requires_grad_(i in wrt)
                 for i, t in enumerate(inputs)]
            out = fn(*x) if batched else torch.func.vmap(fn)(*x)
            grads = [torch.cat(torch.autograd.grad(out[:, i].sum(),
                                                   [x[k] for k in wrt],
                                                   retain_graph=True), dim=-1)
                     for i in range(out.shape[1])]
        return torch.stack(grads, dim=1).detach()


def in_blocks(fn, inputs, block):
    """fn over the leading (state) dimension of ``inputs``, ``block`` states
    at a time, concatenated."""
    B = inputs[0].shape[0]
    return torch.cat([fn(*(x[s:s + block] for x in inputs))
                      for s in range(0, B, block)])

