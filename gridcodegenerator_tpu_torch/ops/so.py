"""Second-order forward dynamics, batch last: the plain PyTorch versions.

The port's counterpart of ``gridcodegenerator_tpu/ops/so.py:98-162``
(``fd_grad_full_bl``, ``forward_dynamics_hessian_bl``). The Hessian is
forward mode over the analytic first-order gradient:

    H[i, j, k] = ∂J[i, j]/∂x_k,   J = [∂q̈/∂q | ∂q̈/∂q̇ | M⁻¹],  x = (q, q̇, u),

one JVP (:func:`jvp`) per argument block (q, q̇, u), as the JAX code
linearizes once per block. The n coordinate directions of a block are
pushed as one batch: each state is repeated over its directions (column
d·B + b holds state b) and the tangent is the one-hot matrix of the
directions, so one JVP computes the whole block.

These are the plain versions the Hessian kernels (``kernels/so_fused.py``,
``kernels/csrc/so.cu``) are held to, and what the wrappers run on CPU
tensors.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..models.robot import RobotModel
from . import blops


def jvp(fn, primals, tangents):
    """(fn(*primals), the derivative of fn along ``tangents``), as
    ``torch.func.jvp``; ``fn`` returns a tensor or a tuple of tensors.
    Built on ``torch.autograd.forward_ad``, whose tangent arithmetic runs as
    ordinary aten operations (so a dispatch-mode counter sees it)."""
    with fwAD.dual_level():
        out = fn(*(fwAD.make_dual(p, t) for p, t in zip(primals, tangents)))
        unpacked = [fwAD.unpack_dual(o) for o in
                    (out if isinstance(out, tuple) else (out,))]
        prim = tuple(u.primal for u in unpacked)
        tan = tuple(torch.zeros_like(u.primal) if u.tangent is None
                    else u.tangent for u in unpacked)
    if isinstance(out, tuple):
        return prim, tan
    return prim[0], tan[0]


def fd_grad_full_bl(model: RobotModel, q, qd, u, gravity=-9.81):
    """[∂q̈/∂q | ∂q̈/∂q̇ | M⁻¹]: q, q̇, u (n, B) → (n, 3n, B), from one
    pipeline (X, v and M⁻¹ computed once)."""
    X = blops.joint_transforms_bl(model, q)
    v, _, f0 = blops.rnea_fwd_bl(model, X, qd, None, gravity)
    c, _ = blops.rnea_bwd_bl(model, X, f0, qd)
    rows, _, _ = blops.minv_bl(model, X)
    Minv = blops.densify_rows(rows)
    qdd = blops.matvecN(Minv, u - c)
    _, a, f = blops.rnea_fwd_bl(model, X, qd, qdd, gravity, v_known=v)
    _, f = blops.rnea_bwd_bl(model, X, f, None)
    dq = blops.rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                                  sides=("q",))["q"]
    ddq = blops.matmatN(Minv, dq, negate=True)
    dqd = blops.rnea_grad_inner_bl(model, X, qd, v, a, f, gravity,
                                   sides=("qd",))["qd"]
    ddqd = blops.matmatN(Minv, dqd, negate=True)
    return torch.cat([ddq, ddqd, Minv], dim=1)


def lam_contract(lam, J):
    """λᵀ·J over the leading axis: lam (n, B), J (n, …, B) → (…, B)."""
    tail = (1,) * (J.dim() - 2)
    return sum(lam[i].reshape(tail + (-1,)) * J[i] for i in range(J.shape[0]))


# ------------------------------------------------------ direction batching
def repeat_dirs(x, nd):
    """(…, B) → (…, nd·B): column d·B + b holds column b, for every d."""
    return x.repeat(*([1] * (x.dim() - 1)), nd)


def split_dirs(x, nd):
    """(…, nd·B) → (nd, …, B): the inverse layout of :func:`repeat_dirs`."""
    return x.reshape(x.shape[:-1] + (nd, -1)).movedim(-2, 0)


def merge_dirs(x):
    """(nd, …, B) → (…, nd·B): per-direction tensors into the repeated
    layout."""
    nd, B = x.shape[0], x.shape[-1]
    return x.movedim(0, -2).reshape(x.shape[1:-1] + (nd * B,))


def one_hot_dirs(n, B, like):
    """The coordinate tangents of one argument block, (n, n·B): direction d
    seeds coordinate d of every state."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return eye[:, :, None].expand(n, n, B).reshape(n, n * B)


def forward_dynamics_hessian_bl(model: RobotModel, q, qd, u, gravity=-9.81,
                                lam=None):
    """∂²q̈/∂x∂x: q, q̇, u (n, B) → (n, 3n, 3n, B), symmetric in the last
    two structure axes; with ``lam`` (n, B), the contraction λᵀ·H,
    (3n, 3n, B). The direction axis k comes after the Jacobian's axes, as
    in the JAX package."""
    n, B = model.n, q.shape[-1]
    args = [repeat_dirs(x, n) for x in (q, qd, u)]
    lam_r = None if lam is None else repeat_dirs(lam, n)
    tangent = one_hot_dirs(n, B, q)
    blocks = []
    for which in range(3):
        def g(z, _w=which):
            J = fd_grad_full_bl(model, *(z if j == _w else args[j]
                                         for j in range(3)), gravity)
            return J if lam_r is None else lam_contract(lam_r, J)

        _, dJ = jvp(g, (args[which],), (tangent,))
        blocks.append(dJ.reshape(dJ.shape[:-1] + (n, B)))
    return torch.cat(blocks, dim=-2)
