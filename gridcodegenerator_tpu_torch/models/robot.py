"""RobotModel — the per-robot constants as torch tensors.

The port's counterpart of ``gridcodegenerator_tpu/models/robot.py``. Every
joint transform is an affine function of ``(sin q, cos q)`` (revolute) or
``q`` (prismatic):

    X_i(q_i) = Xb_i + f1(q_i) · Xs_i + f2(q_i) · Xc_i

with ``f1 = sin, f2 = cos`` for revolute and ``f1 = id, f2 = 0`` for
prismatic joints. The coefficient functions below are the JAX package's NumPy
code, unchanged, so both packages start from bit-identical float64 constants.

The model holds plain tensors on one device in one dtype; ``.to(device,
dtype)`` returns a copy elsewhere. Models are built on the card
(``device="cuda"``) unless the caller names another device; where there is
no CUDA device that default raises rather than building on the CPU. The
topology and joint types are static Python data: the CUDA kernels are
compiled once per topology from them (``ops/kernels/_build.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .topology import Topology
from .urdf import RobotDescription, parse_urdf, rpy_to_matrix, skew

# the per-robot constant tensors, in the order the kernels' packed buffer
# holds them (``RobotModel.packed``)
MODEL_FIELDS = ("Xb", "Xs", "Xc", "S", "inertia", "damping", "armature")


def _origin_xform(R: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Constant spatial motion transform of a joint origin: child frame pose
    (R, r) in parent coordinates → ``X = [[E,0],[−E·r̂,E]]`` with ``E = Rᵀ``."""
    E = R.T
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ skew(r)
    return X


def joint_xform_coefficients(desc: RobotDescription):
    """Precompute (Xb, Xs, Xc) stacks, each (n, 6, 6) float64."""
    n = desc.n
    Xb = np.zeros((n, 6, 6))
    Xs = np.zeros((n, 6, 6))
    Xc = np.zeros((n, 6, 6))
    I6 = np.eye(6)
    for i in range(n):
        R = rpy_to_matrix(desc.origin_rpy[i])
        XT = _origin_xform(R, desc.origin_xyz[i])
        a = desc.axis[i]
        if desc.joint_types[i] == "prismatic":
            L6 = np.zeros((6, 6))
            L6[3:, :3] = -skew(a)
            Xb[i] = XT
            Xs[i] = L6 @ XT
            # Xc stays 0
        else:  # revolute / continuous
            K = skew(a)
            K6 = np.zeros((6, 6))
            K6[:3, :3] = K
            K6[3:, 3:] = K
            K6sq = K6 @ K6
            Xb[i] = (I6 + K6sq) @ XT
            Xs[i] = -K6 @ XT
            Xc[i] = -K6sq @ XT
    return Xb, Xs, Xc


def joint_motion_subspaces(desc: RobotDescription) -> np.ndarray:
    """S vectors, (n, 6): ``[axis; 0]`` revolute, ``[0; axis]`` prismatic."""
    S = np.zeros((desc.n, 6))
    for i in range(desc.n):
        if desc.joint_types[i] == "prismatic":
            S[i, 3:] = desc.axis[i]
        else:
            S[i, :3] = desc.axis[i]
    return S


@dataclass(frozen=True, eq=False)
class RobotModel:
    """Per-robot constants on one device, in one dtype."""

    Xb: torch.Tensor          # (n, 6, 6) constant term of X_i(q)
    Xs: torch.Tensor          # (n, 6, 6) sin/linear coefficient
    Xc: torch.Tensor          # (n, 6, 6) cos coefficient
    S: torch.Tensor           # (n, 6) joint motion subspace
    inertia: torch.Tensor     # (n, 6, 6) link spatial inertias
    damping: torch.Tensor     # (n,) viscous joint damping
    armature: torch.Tensor    # (n,) reflected rotor inertia (M → M + diag)
    prismatic: torch.Tensor   # (n,) bool mask
    topology: Topology
    name: str
    joint_types: tuple = ()

    @property
    def n(self) -> int:
        return self.topology.n

    @property
    def dtype(self) -> torch.dtype:
        return self.Xb.dtype

    @property
    def device(self) -> torch.device:
        return self.Xb.device

    def to(self, device=None, dtype=None) -> "RobotModel":
        """A copy with every float tensor on ``device`` in ``dtype`` (either
        may be None to keep the current one)."""
        moved = {f: getattr(self, f).to(device=device, dtype=dtype)
                 for f in MODEL_FIELDS}
        return dataclasses.replace(
            self, prismatic=self.prismatic.to(device=device), **moved)

    @functools.cached_property
    def packed(self) -> torch.Tensor:
        """The constants flattened into one contiguous buffer in
        ``MODEL_FIELDS`` order — the layout the CUDA kernels stage into
        shared memory (``csrc/rbd.cuh``)."""
        return torch.cat([getattr(self, f).reshape(-1)
                          for f in MODEL_FIELDS]).contiguous()


def _require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist — the port
    never quietly builds on the CPU when the card was asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False): models are built on the card by default; pass "
            "device='cpu' to build one on the CPU")
    return device


def robot_model_from_description(desc: RobotDescription,
                                 dtype=torch.float32, device="cuda",
                                 accurate_trig: bool = False) -> RobotModel:
    if accurate_trig:
        raise NotImplementedError(
            "accurate_trig (the JAX package's ops/trig.py sincos) is not "
            "ported yet: ROADMAP Queue 1, 'The per-state tier and "
            "differentiability'")
    if any(t in ("spherical", "floating") for t in desc.joint_types):
        raise ValueError(
            "robot has multi-dof (spherical/floating) joints — build it with "
            "ops/multidof.py::multidof_model_from_description instead of the "
            "single-dof RobotModel")
    Xb, Xs, Xc = joint_xform_coefficients(desc)
    S = joint_motion_subspaces(desc)
    armature = (np.zeros(desc.n) if desc.armature is None
                else np.asarray(desc.armature, np.float64))
    arrays = dict(Xb=Xb, Xs=Xs, Xc=Xc, S=S, inertia=desc.inertia,
                  damping=desc.damping, armature=armature)
    return _from_arrays(arrays, desc.topology, desc.joint_types, desc.name,
                        dtype, device)


def from_jax_arrays(arrays: dict, parents, joint_types, name: str,
                    device="cuda") -> RobotModel:
    """Build the port's model on ``device`` from the leaves of a JAX
    ``RobotModel`` given as numpy arrays keyed by field name (``Xb``,
    ``Xs``, ``Xc``, ``S``, ``inertia``, ``damping``, ``armature``), keeping
    their dtype."""
    topo = Topology(tuple(int(p) for p in parents))
    dtype = torch.as_tensor(np.array(arrays["Xb"])).dtype
    return _from_arrays(arrays, topo, joint_types, name, dtype, device)


def _from_arrays(arrays, topology, joint_types, name, dtype, device):
    device = _require_device(device)
    fields = {f: torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                              device=device) for f in MODEL_FIELDS}
    prism = torch.tensor([t == "prismatic" for t in joint_types],
                         device=device)
    return RobotModel(**fields, prismatic=prism, topology=topology,
                      name=name, joint_types=tuple(joint_types))


def load_robot(urdf: str, dtype=torch.float32, device="cuda") -> RobotModel:
    """Parse a URDF (path or XML string) into a :class:`RobotModel`."""
    return robot_model_from_description(parse_urdf(urdf), dtype=dtype,
                                        device=device)
