"""Launch bookkeeping shared by the kernel wrappers (:mod:`.fused`,
:mod:`.staged`, :mod:`.so_fused`, :mod:`.so_staged`,
:mod:`.multidof_fused`, :mod:`.multidof_staged`, :mod:`.contact_fused`):
input checks, output allocation, the ctypes launch and the per-kernel
``LAUNCHES`` counters. A counter rises only on a successful launch, never
on a CPU tensor's plain version."""

from __future__ import annotations

import torch

from ...models.robot import RobotModel
from . import _build

LAUNCHES = {
    # csrc/fused.cu: the single-kernel families
    "inverse_dynamics": 0, "minv": 0, "id_grad": 0, "fd_grad": 0, "aba": 0,
    "fd_grad_dense": 0, "fd": 0,
    # csrc/staged.cu: the staged pipeline (K5 one side a launch: "_side";
    # reading bf16 stage tensors: "_bf16")
    "bias_and_v": 0, "minv_dense": 0, "af": 0, "vaf": 0, "grad_cols": 0,
    "grad_cols_finish": 0, "af_bf16": 0, "grad_cols_side": 0,
    "grad_cols_finish_side": 0, "grad_cols_bf16": 0,
    "grad_cols_finish_bf16": 0, "grad_cols_side_bf16": 0,
    "grad_cols_finish_side_bf16": 0, "fd_dense": 0, "minv_af": 0,
    "minv_ud": 0, "minv_cols": 0,
    # K5, K2′, K1, K4, vaf and the recursion ∇FD on the one-thread kernels
    # the CTA tiles replaced (DESIGN = "thread", a timed arm)
    **{f"{k}{f}{sd}{b}_thread": 0 for k in ("grad_cols",)
       for f in ("", "_finish") for sd in ("", "_side")
       for b in ("", "_bf16")},
    "minv_dense_thread": 0, "bias_and_v_thread": 0, "af_thread": 0,
    "af_bf16_thread": 0, "vaf_thread": 0, "fd_grad_thread": 0,
    # csrc/so.cu: the single-thread Hessians and the staged tangent stages
    "hessian_vp": 0, "hessian": 0, "t1": 0, "t2": 0, "t4": 0, "t5": 0,
    # csrc/md.cu: the multi-dof (ball and free joint) families
    "md_id": 0, "md_aba": 0, "md_id_grad": 0, "md_fd_grad": 0, "md_fd": 0,
    # csrc/md_staged.cu: the staged multi-dof pipeline
    "md_vaf": 0, "md_minv": 0, "md_minv_qdd": 0, "md_grad_cols": 0,
    "md_grad_cols_finish": 0,
    # csrc/ff.cu: the floating-base families and the ground steps
    "fb_aba": 0, "fb_fd": 0, "stance_fd": 0, "step_ground": 0,
    "step_ground_terrain": 0,
    # csrc/md_step.cu: the multi-dof ground step
    "md_step_ground": 0,
}

_DTYPE_TAGS = {torch.float32: "f32", torch.float64: "f64"}

# "tile": K1, K2′, K4, K5, ∂ID's vaf (staged) and the recursion ∇FD (fused)
# launch the CTA tiles; "thread": the one-thread kernels they replaced
DESIGN = "tile"


def design(name, entry=None):
    """The LAUNCHES key and the C entry of a tiled kernel under
    ``DESIGN``."""
    entry = entry or f"grid_{name}"
    if DESIGN == "tile":
        return name, entry
    if DESIGN == "thread":
        return f"{name}_thread", f"{entry}_thread"
    raise ValueError(f"DESIGN must be 'tile' or 'thread', got {DESIGN!r}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(x) -> bool:
    return x.device.type == "cpu"


def _check_device(model, ref) -> None:
    if ref.device.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {ref.device}")
    if ref.dtype not in _DTYPE_TAGS:
        raise TypeError(f"kernels take float32 or float64, got {ref.dtype}")
    if model.device != ref.device or model.dtype != ref.dtype:
        raise ValueError(
            f"model is on {model.device} in {model.dtype}, states on "
            f"{ref.device} in {ref.dtype}: move it with model.to(...)")


def _check_state(s, ref, rows: int, label: str) -> None:
    if s.device != ref.device or s.dtype != ref.dtype:
        raise ValueError("states must share one device and dtype")
    if s.dim() != 2 or tuple(s.shape) != (rows, ref.shape[-1]):
        raise ValueError(f"states must be ({label}={rows}, B), got "
                         f"{tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("states must be contiguous")


def check(model: RobotModel, states) -> int:
    """Validate (n, B) states for a kernel launch; returns B."""
    ref = states[0]
    _check_device(model, ref)
    for s in states:
        _check_state(s, ref, model.n, "n")
    return ref.shape[-1]


def check_md(model, q, others) -> int:
    """Validate a multi-dof launch's states: q (nq, B), the others — q̇,
    q̈, u — (nv, B); returns B."""
    _check_device(model, q)
    _check_state(q, q, model.nq, "nq")
    for s in others:
        _check_state(s, q, model.nv, "nv")
    return q.shape[-1]


def check_md_step(model, q, qd, tau, mu, k: int) -> int:
    """Validate a multi-dof ground step's inputs: q (nq, B), q̇ and τ (nv,
    B), μ (k, B) for its k contacts; returns B."""
    B = check_md(model, q, (qd, tau))
    _check_state(mu, q, k, "k")
    return B


def check_ff(model, states) -> int:
    """Validate a floating-base launch's states, given as (tensor, rows,
    label) — quat (4, B), q (n, B), vb (6, B), a step's μ (k, B) and push
    (6, B), … —; returns B."""
    ref = states[0][0]
    _check_device(model, ref)
    for s, rows, label in states:
        _check_state(s, ref, rows, label)
    return ref.shape[-1]


def check_staged(model, name: str, t, shape, dtype=None) -> None:
    """A staged input (v, a, f, M⁻¹, …) on the model's device, in the
    model's dtype or ``dtype`` (bf16 staging), in its contiguous (…, B)
    layout."""
    dtype = dtype or model.dtype
    if (t.device != model.device or t.dtype != dtype
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {shape} tensor on "
                         f"{model.device} in {dtype}, got "
                         f"{tuple(t.shape)} on {t.device} in {t.dtype}")


def ptr(x):
    """A tensor's device pointer, or None (NULL) for an absent input."""
    return None if x is None else x.data_ptr()


def launch(name: str, entry: str, model: RobotModel, ptrs, B: int,
           *scalars, links=None, pairs=None) -> None:
    """Call ``entry`` of the model's kernel library (its unit built if it
    is not yet; for the stance and step kernels, the library of ``links``
    and a step's collision and loop ``pairs``) on the current stream and
    count the launch under ``name``."""
    lib = _build.library(model, (_build.unit_of(entry),), links=links,
                         pairs=pairs)
    device = model.device
    fn = lib.entry(entry, _DTYPE_TAGS[model.dtype])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(model.packed.data_ptr(), *ptrs, B, *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: {lib.error_string(rc)} "
                           f"({rc})")
    LAUNCHES[name] += 1


def empty(model, *shape):
    return torch.empty(shape, dtype=model.dtype, device=model.device)
