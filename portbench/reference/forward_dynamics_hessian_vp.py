"""Reference of ``forward_dynamics_hessian_vp``: λᵀ·∂²q̈/∂x∂x (S, 3n, 3n),
x = (q, q̇, u), the reverse-over-reverse second derivative of λ·q̈(x) for
the plain forward dynamics."""

import torch

INPUTS = ("q", "qd", "u", "lam")
BLOCK = 256


def reference(dyn, q, qd, u, lam):
    n = dyn.n

    def weighted(x, lam_):
        return torch.dot(lam_, dyn.fd(x[:n], x[n:2 * n], x[2 * n:]))

    def gradient(x, lam_):
        w = torch.func.vmap(weighted)(x, lam_)
        return torch.autograd.grad(w.sum(), x, create_graph=True)[0]

    return dyn.jacobian_rows(gradient, (torch.cat([q, qd, u], dim=-1), lam),
                             wrt=(0,), batched=True)
