"""Multi-dof joints: ball (spherical) and true 6-dof free (floating) joints.

The port's counterpart of ``gridcodegenerator_tpu/ops/multidof.py``: the
generalized model, whose joints have motion subspaces S ∈ ℝ^{6×k}, and its
four batched entry points.

* **spherical** joints: k = 3 angular dof; the position coordinates are a
  unit quaternion (w, x, y, z) (4 slots in q), the velocity coordinates the
  child-relative body angular velocity ω (3 slots in q̇), so S = [I₃; 0].
* **floating** joints: k = 6; q holds the quaternion and the position in
  the parent frame (7 slots), q̇ the child-body twist [ω; v], S = I₆.
* revolute and prismatic joints: k = 1, as in the single-dof stack.

So nq ≠ nv in general (``MultiDofModel.nq`` / ``.nv``). Derivatives are
taken in the tangent space: the attitude moves by ``quat ⊗ exp(½δ)`` and a
free joint's position by a body-frame translation (:func:`md_tangent_apply`).

The batched entries take batch-first states, q (..., nq) and q̇, q̈, u
(..., nv), move them to the batch-last (nq|nv, B) layout and call the
wrappers of :mod:`.kernels.multidof_fused` — or, for the two gradient
families past ``MAX_MD_GRAD_NV`` velocity coordinates, of the staged
pipeline :mod:`.kernels.multidof_staged` (the JAX package's routing,
multidof.py:524, :551): the CUDA kernels on CUDA tensors, their plain
PyTorch versions (:mod:`.md_blops`) on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..api import _check_impl, _cols, _unflat
from ..models.robot import _origin_xform, _require_device
from ..models.topology import Topology
from ..models.urdf import RobotDescription, rpy_to_matrix, skew
from .freeflyer import quat_exp_body, quat_mul, quat_to_rot
from .kernels import _build
from .kernels import multidof_fused as _mf
from .kernels import multidof_staged as _ms

# the per-robot constant tensors (``MultiDofModel``), in field order
MD_FIELDS = ("XT", "S", "inertia", "damping", "armature", "axis")
# joint type → (q slots, v slots)
_WIDTHS = {"floating": (7, 6), "spherical": (4, 3), "prismatic": (1, 1),
           "revolute": (1, 1)}


@dataclass(frozen=True, eq=False)
class MultiDofModel:
    """Per-robot constants of a mixed single-/multi-dof tree, on one device
    in one dtype."""

    XT: torch.Tensor        # (n, 6, 6) constant origin transforms
    S: torch.Tensor         # (n, 6, 6) motion subspaces, zero-padded
    inertia: torch.Tensor   # (n, 6, 6)
    damping: torch.Tensor   # (nv,) per velocity coordinate
    armature: torch.Tensor  # (nv,) reflected rotor inertia per coordinate
    axis: torch.Tensor      # (n, 3) single-dof axes (unused for ball/free)
    topology: Topology
    name: str
    joint_types: tuple = ()
    q_slices: tuple = ()    # (start, width) per joint
    v_slices: tuple = ()

    @property
    def n(self) -> int:
        return self.topology.n

    @property
    def nq(self) -> int:
        s, w = self.q_slices[-1]
        return s + w

    @property
    def nv(self) -> int:
        s, w = self.v_slices[-1]
        return s + w

    @property
    def dtype(self) -> torch.dtype:
        return self.XT.dtype

    @property
    def device(self) -> torch.device:
        return self.XT.device

    def to(self, device=None, dtype=None) -> "MultiDofModel":
        """A copy with every tensor on ``device`` in ``dtype`` (either may be
        None to keep the current one)."""
        moved = {f: getattr(self, f).to(device=device, dtype=dtype)
                 for f in MD_FIELDS}
        return dataclasses.replace(self, **moved)

    @functools.cached_property
    def S_np(self) -> np.ndarray:
        """S in float64 NumPy: the plain bodies fold its entries as
        constants and skip its zeros, as the JAX kernel bodies do."""
        return self.S.detach().cpu().double().numpy()

    @functools.cached_property
    def rot_coeffs(self) -> tuple[np.ndarray, np.ndarray]:
        """(K, K·K) of every joint's axis, (n, 3, 3) float64: a revolute
        joint's rotation is I − sin q·K + (1 − cos q)·K·K."""
        axis = self.axis.detach().cpu().double().numpy()
        K = np.stack([skew(a) for a in axis])
        return K, np.stack([k @ k for k in K])

    @functools.cached_property
    def packed(self) -> torch.Tensor:
        """The constants the CUDA kernels stage into shared memory
        (``csrc/md.cuh``), in this order: XT (36n), inertia (36n), K (9n),
        K·K (9n), S's first column (6n; a single-dof joint's S), damping
        (nv), armature (nv)."""
        K, KK = (torch.as_tensor(x, dtype=self.dtype, device=self.device)
                 for x in self.rot_coeffs)
        parts = (self.XT, self.inertia, K, KK, self.S[:, :, 0],
                 self.damping, self.armature)
        return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _slices(joint_types):
    q_slices, v_slices = [], []
    qs = vs = 0
    for t in joint_types:
        wq, wv = _WIDTHS["revolute" if t == "continuous" else t]
        q_slices.append((qs, wq))
        v_slices.append((vs, wv))
        qs += wq
        vs += wv
    return tuple(q_slices), tuple(v_slices)


def multidof_model_from_description(desc: RobotDescription,
                                    dtype=torch.float64,
                                    device="cuda") -> MultiDofModel:
    """The model of a URDF description with any mix of floating (7, 6
    coordinate slots), spherical (4, 3) and single-dof (1, 1) joints; the
    same float64 constants as the JAX package's
    ``multidof_model_from_description``, and its default dtype (float64:
    pass ``dtype=torch.float32`` for the card's fast path)."""
    n = desc.n
    XT = np.zeros((n, 6, 6))
    S = np.zeros((n, 6, 6))
    for i in range(n):
        XT[i] = _origin_xform(rpy_to_matrix(desc.origin_rpy[i]),
                              desc.origin_xyz[i])
        t = desc.joint_types[i]
        if t == "floating":
            S[i] = np.eye(6)
        elif t == "spherical":
            S[i, :3, :3] = np.eye(3)
        elif t == "prismatic":
            S[i, 3:, 0] = desc.axis[i]
        else:
            S[i, :3, 0] = desc.axis[i]
    q_slices, v_slices = _slices(desc.joint_types)
    damping = np.concatenate(
        [np.full(v_slices[i][1], desc.damping[i]) for i in range(n)])
    arm_j = (np.zeros(n) if desc.armature is None
             else np.asarray(desc.armature, np.float64))
    armature = np.concatenate(
        [np.full(v_slices[i][1], arm_j[i]) for i in range(n)])
    arrays = dict(XT=XT, S=S, inertia=desc.inertia, damping=damping,
                  armature=armature, axis=desc.axis)
    return _md_from_arrays(arrays, desc.topology, desc.joint_types,
                           q_slices, v_slices, desc.name, dtype, device)


def md_from_jax_arrays(arrays: dict, parents, joint_types, q_slices,
                       v_slices, name: str, dtype=None,
                       device="cuda") -> MultiDofModel:
    """The port's model from the leaves of a JAX ``MultiDofModel`` given as
    numpy arrays keyed by field name (``XT``, ``S``, ``inertia``,
    ``damping``, ``armature``, ``axis``); ``dtype=None`` keeps theirs."""
    if dtype is None:
        dtype = torch.as_tensor(np.array(arrays["XT"])).dtype
    topo = Topology(tuple(int(p) for p in parents))
    return _md_from_arrays(arrays, topo, joint_types,
                           tuple(tuple(int(x) for x in s) for s in q_slices),
                           tuple(tuple(int(x) for x in s) for s in v_slices),
                           name, dtype, device)


def _md_from_arrays(arrays, topology, joint_types, q_slices, v_slices, name,
                    dtype, device):
    device = _require_device(device)
    fields = {f: torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                              device=device) for f in MD_FIELDS}
    return MultiDofModel(**fields, topology=topology, name=name,
                         joint_types=tuple(joint_types), q_slices=q_slices,
                         v_slices=v_slices)


def neutral_q(model: MultiDofModel) -> torch.Tensor:
    """The identity configuration (unit quaternions, zeros elsewhere),
    (nq,)."""
    q = np.zeros(model.nq)
    for i, t in enumerate(model.joint_types):
        if t in ("spherical", "floating"):
            q[model.q_slices[i][0]] = 1.0
    return torch.as_tensor(q, dtype=model.dtype, device=model.device)


def md_tangent_apply(model: MultiDofModel, q, dq_tangent):
    """Retract tangent steps onto the configuration manifold, batched:
    q (..., nq), δ (..., nv) → (..., nq). Quaternion joints advance by
    ``quat ⊗ exp(½δφ)`` (renormalised); a free joint's position by the
    body-frame translation δ[3:] rotated into the parent frame (the chart
    in which ∂X/∂μ = −crm(S e_k)·X for all six columns); 1-dof joints add."""
    parts = []
    for i, t in enumerate(model.joint_types):
        s, w = model.q_slices[i]
        sv, wv = model.v_slices[i]
        d = dq_tangent[..., sv:sv + wv]
        if t in ("floating", "spherical"):
            quat = q[..., s:s + 4]
            new = quat_mul(quat, quat_exp_body(d[..., :3]))
            parts.append(new / torch.linalg.vector_norm(new, dim=-1,
                                                        keepdim=True))
            if t == "floating":
                rot = quat_to_rot(quat)
                parts.append(q[..., s + 4:s + 7]
                             + (rot @ d[..., 3:, None])[..., 0])
        else:
            parts.append(q[..., s:s + 1] + d)
    return torch.cat(parts, -1)


# ------------------------------------------------------- batched entries
def _check_md_states(model, states, names):
    """Fail fast on malformed states: q ends in nq, the others in nv, and
    all share one batch shape."""
    named = [(nm, s) for nm, s in zip(names, states) if s is not None]
    for nm, s in named:
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"{nm} must be a torch.Tensor, got {type(s)}")
        want, label = ((model.nq, "nq") if nm == "q" else (model.nv, "nv"))
        if s.dim() == 0 or s.shape[-1] != want:
            raise ValueError(
                f"{nm} must have trailing dimension {label}={want} (robot "
                f"'{model.name}': nq={model.nq}, nv={model.nv}), got shape "
                f"{tuple(s.shape)}")
    if len({tuple(s.shape[:-1]) for _, s in named}) > 1:
        raise ValueError(
            "state batch shapes disagree: "
            + ", ".join(f"{nm}={tuple(s.shape)}" for nm, s in named))


def md_inverse_dynamics_batched(model: MultiDofModel, q, qd, qdd=None,
                                gravity=-9.81, impl="auto"):
    """Generalized inverse dynamics: q (..., nq), q̇ and q̈ (..., nv) →
    c (..., nv); ``qdd=None`` gives the bias force."""
    _check_md_states(model, (q, qd, qdd), ("q", "qd", "qdd"))
    _check_impl(impl, q)
    c = _mf.md_id_fused(model, _cols(q), _cols(qd), _cols(qdd), gravity)
    return _unflat(c, tuple(qd.shape[:-1]))


def md_forward_dynamics_batched(model: MultiDofModel, q, qd, u,
                                gravity=-9.81, impl="auto"):
    """Generalized forward dynamics by the articulated-body algorithm with
    k×k joint blocks: q (..., nq), q̇ and u (..., nv) → q̈ (..., nv);
    ``impl="crba"`` takes the CRBA + dense Cholesky kernel instead."""
    _check_md_states(model, (q, qd, u), ("q", "qd", "u"))
    _check_impl("auto" if impl == "crba" else impl, q)
    kern = _mf.md_fd_fused if impl == "crba" else _mf.md_aba_fused
    qdd = kern(model, _cols(q), _cols(qd), _cols(u), gravity)
    return _unflat(qdd, tuple(qd.shape[:-1]))


def md_id_grad_batched(model: MultiDofModel, q, qd, qdd=None, gravity=-9.81,
                       impl="auto"):
    """Tangent-space ∂ID: q (..., nq), q̇ and q̈ (..., nv) → (∂τ/∂δq,
    ∂τ/∂q̇), each (..., nv, nv); past ``MAX_MD_GRAD_NV`` through the staged
    pipeline."""
    _check_md_states(model, (q, qd, qdd), ("q", "qd", "qdd"))
    _check_impl(impl, q)
    fn = (_mf.md_id_grad_fused if _build.md_dense_grads(model.nv)
          else _ms.md_id_grad_staged)
    outs = fn(model, _cols(q), _cols(qd), _cols(qdd), gravity)
    return tuple(_unflat(D, tuple(qd.shape[:-1])) for D in outs)


def md_forward_dynamics_gradient_batched(model: MultiDofModel, q, qd, u,
                                         gravity=-9.81, impl="auto"):
    """Tangent-space ∇FD: (∂q̈/∂δq, ∂q̈/∂q̇, ∂q̈/∂u), each (..., nv, nv) —
    the Carpentier–Mansard pipeline in one kernel, or past
    ``MAX_MD_GRAD_NV`` in the staged pipeline's three."""
    _check_md_states(model, (q, qd, u), ("q", "qd", "u"))
    _check_impl(impl, q)
    fn = (_mf.md_fd_grad_fused if _build.md_dense_grads(model.nv)
          else _ms.md_fd_grad_staged)
    outs = fn(model, _cols(q), _cols(qd), _cols(u), gravity)
    return tuple(_unflat(D, tuple(qd.shape[:-1])) for D in outs)
