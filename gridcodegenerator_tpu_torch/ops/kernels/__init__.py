from .fused import (
    fd_grad_fused,
    forward_dynamics_fused,
    id_grad_fused,
    inverse_dynamics_fused,
    minv_fused,
)
