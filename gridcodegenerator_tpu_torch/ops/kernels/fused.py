"""The port's four first-order kernels and their plain PyTorch versions.

Counterparts of ``gridcodegenerator_tpu/ops/kernels/fused.py:270-472`` with
the same batch-last (n, B) signatures. Each wrapper

* on a CPU tensor runs its plain version (``*_plain``, built from
  :mod:`..blops`), the CPU counterpart of the JAX package's ``"bl"`` path;
* on a CUDA tensor launches its hand-written kernel (``csrc/fused.cu``,
  built for the robot's topology at first use by :mod:`._build`), or raises.
  There is no fallback from the kernel to the plain version.

``LAUNCHES`` counts the kernel launches of each wrapper; only a successful
launch adds to it.
"""

from __future__ import annotations

import torch

from ...models.robot import RobotModel
from .. import blops
from . import _build

LAUNCHES = {"inverse_dynamics": 0, "minv": 0, "id_grad": 0, "fd_grad": 0}

# One thread per state keeps the whole ∇FD working set in local memory
# (ptxas: 5.7 KB a thread at n=7 in float32, ≈ 28·n² values); past this
# joint count that reaches tens of KB a thread. Larger robots need the
# staged pipeline (ROADMAP Queue 1 item 5).
MAX_KERNEL_JOINTS = 16

_DTYPE_TAGS = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# plain versions (any device)
# --------------------------------------------------------------------------
def inverse_dynamics_plain(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    c, *_ = blops.rnea_bl(model, q, qd, qdd, gravity)
    return c


def minv_plain(model: RobotModel, q):
    rows, _, _ = blops.minv_bl(model, blops.joint_transforms_bl(model, q))
    return blops.densify_rows(rows)


def id_grad_plain(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    if qdd is None:
        qdd = torch.zeros_like(q)
    X = blops.joint_transforms_bl(model, q)
    v, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity)
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    dq = blops.rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                                  sides=("q",))["q"]
    dqd = blops.rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                                   sides=("qd",))["qd"]
    return dq, dqd


def fd_grad_plain(model: RobotModel, q, qd, u, gravity=-9.81):
    return blops.fd_grad_bl(model, q, qd, u, gravity)


# --------------------------------------------------------------------------
# kernel launch
# --------------------------------------------------------------------------
def _on_cpu(x) -> bool:
    return x.device.type == "cpu"


def _check(model: RobotModel, states) -> int:
    """Validate (n, B) states for a kernel launch; returns B."""
    ref = states[0]
    if ref.device.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {ref.device}")
    if ref.dtype not in _DTYPE_TAGS:
        raise TypeError(f"kernels take float32 or float64, got {ref.dtype}")
    if model.device != ref.device or model.dtype != ref.dtype:
        raise ValueError(
            f"model is on {model.device} in {model.dtype}, states on "
            f"{ref.device} in {ref.dtype}: move it with model.to(...)")
    if model.n > MAX_KERNEL_JOINTS:
        raise NotImplementedError(
            f"robot '{model.name}' has {model.n} joints; the single-state "
            f"kernels take at most {MAX_KERNEL_JOINTS} (the staged "
            "large-robot pipeline is ROADMAP Queue 1 item 5)")
    shape = (model.n, ref.shape[-1]) if ref.dim() == 2 else None
    for s in states:
        if s.device != ref.device or s.dtype != ref.dtype:
            raise ValueError("states must share one device and dtype")
        if tuple(s.shape) != shape:
            raise ValueError(f"states must be (n={model.n}, B), got "
                             f"{tuple(s.shape)}")
        if not s.is_contiguous():
            raise ValueError("states must be contiguous")
    return shape[1]


def _launch(name: str, entry: str, model: RobotModel, ptrs, B: int,
            *scalars) -> None:
    lib = _build.library(model)
    device = model.device
    fn = lib.entry(entry, _DTYPE_TAGS[model.dtype])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(model.packed.data_ptr(), *ptrs, B, *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: {lib.error_string(rc)} "
                           f"({rc})")
    LAUNCHES[name] += 1


def _empty(model, *shape):
    return torch.empty(shape, dtype=model.dtype, device=model.device)


# --------------------------------------------------------------------------
# public wrappers (batch-last signatures: states are (n, B))
# --------------------------------------------------------------------------
def inverse_dynamics_fused(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    """RNEA: q, q̇[, q̈] (n,B) → c (n,B); ``qdd=None`` is the bias force."""
    if _on_cpu(q):
        return inverse_dynamics_plain(model, q, qd, qdd, gravity)
    states = [q, qd] if qdd is None else [q, qd, qdd]
    B = _check(model, states)
    c = _empty(model, model.n, B)
    if B:
        _launch("inverse_dynamics", "grid_rnea", model,
                (q.data_ptr(), qd.data_ptr(),
                 None if qdd is None else qdd.data_ptr(), c.data_ptr()),
                B, float(gravity))
    return c


def minv_fused(model: RobotModel, q):
    """Analytic M⁻¹: q (n,B) → dense symmetric (n,n,B)."""
    if _on_cpu(q):
        return minv_plain(model, q)
    B = _check(model, [q])
    M = _empty(model, model.n, model.n, B)
    if B:
        _launch("minv", "grid_minv", model, (q.data_ptr(), M.data_ptr()), B)
    return M


def id_grad_fused(model: RobotModel, q, qd, qdd=None, gravity=-9.81):
    """∂ID: returns (∂c/∂q, ∂c/∂q̇), each (n,n,B)."""
    if _on_cpu(q):
        return id_grad_plain(model, q, qd, qdd, gravity)
    if qdd is None:
        qdd = torch.zeros_like(q)  # S·0 adds nothing: the same as no q̈ term
    B = _check(model, [q, qd, qdd])
    dq = _empty(model, model.n, model.n, B)
    dqd = _empty(model, model.n, model.n, B)
    if B:
        _launch("id_grad", "grid_id_grad", model,
                (q.data_ptr(), qd.data_ptr(), qdd.data_ptr(), dq.data_ptr(),
                 dqd.data_ptr()), B, float(gravity))
    return dq, dqd


def fd_grad_fused(model: RobotModel, q, qd, u, gravity=-9.81):
    """∇FD — the north-star kernel: X → RNEA → M⁻¹ → q̈ → second RNEA sweep
    → ∂ID → −M⁻¹·∂c in one launch. Returns (∂q̈/∂q, ∂q̈/∂q̇), each (n,n,B)."""
    if _on_cpu(q):
        return fd_grad_plain(model, q, qd, u, gravity)
    B = _check(model, [q, qd, u])
    ddq = _empty(model, model.n, model.n, B)
    ddqd = _empty(model, model.n, model.n, B)
    if B:
        _launch("fd_grad", "grid_fd_grad", model,
                (q.data_ptr(), qd.data_ptr(), u.data_ptr(), ddq.data_ptr(),
                 ddqd.data_ptr()), B, float(gravity))
    return ddq, ddqd
