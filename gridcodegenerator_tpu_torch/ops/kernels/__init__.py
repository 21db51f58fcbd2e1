from .fused import (
    fd_grad_fused,
    id_grad_fused,
    inverse_dynamics_fused,
    minv_fused,
)
