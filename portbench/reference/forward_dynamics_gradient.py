"""Reference of ``forward_dynamics_gradient``: [∂q̈/∂q | ∂q̈/∂q̇] (S, n, 2n),
the reverse-mode derivative of the plain forward dynamics."""

INPUTS = ("q", "qd", "u")
BLOCK = 1024   # states a call of the vectorised derivative holds


def reference(dyn, q, qd, u):
    return dyn.jacobian_rows(dyn.fd, (q, qd, u), wrt=(0, 1))
