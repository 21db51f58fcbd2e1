"""Reference of ``inverse_dynamics_gradient``: [∂c/∂q | ∂c/∂q̇] (S, n, 2n)
at the given q̈, the reverse-mode derivative of the plain inverse
dynamics."""

INPUTS = ("q", "qd", "qdd")
BLOCK = 1024


def reference(dyn, q, qd, qdd):
    return dyn.jacobian_rows(dyn.rnea, (q, qd, qdd), wrt=(0, 1))
