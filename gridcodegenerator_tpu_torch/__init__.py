"""gridcodegenerator_tpu_torch — the PyTorch / CUDA port of
:mod:`gridcodegenerator_tpu`.

The same batched rigid-body dynamics on torch tensors: plain PyTorch
batch-last versions on any device, and hand-written CUDA kernels for the
NVIDIA H100 (``ops/kernels/csrc``), built per robot topology at first use.
This package imports torch and never jax.

The five first-order families, for every fixed-base robot (past 11 joints
∇FD, ∂ID and M⁻¹ run through the staged pipeline, ``ops/kernels/staged``):
  * inverse dynamics (RNEA)              → :func:`inverse_dynamics`, :func:`bias_force`
  * forward dynamics (ABA)               → :func:`forward_dynamics`
  * analytical mass-matrix inverse       → :func:`direct_minv`
  * analytical ∂ID (∂c/∂q, ∂c/∂q̇)        → :func:`inverse_dynamics_gradient`
  * analytical ∇FD (−M⁻¹·∂c/∂u)          → :func:`forward_dynamics_gradient`

Second order (forward mode over the analytic ∇FD; λᵀ·H past 2 joints and H
past 12 run through the staged pipeline, ``ops/kernels/so_staged``):
  * [∂q̈/∂q | ∂q̈/∂q̇ | M⁻¹]                → :func:`forward_dynamics_gradient_full`
  * ∂²q̈/∂x∂x, x = (q, q̇, u)              → :func:`forward_dynamics_hessian`
  * λᵀ·∂²q̈/∂x∂x (the DDP curvature term) → :func:`forward_dynamics_hessian_vp`

Multi-dof joints (ball and free joints, nq ≠ nv; ``ops/multidof``), built
with :func:`multidof_model_from_description`, batched q (..., nq) and
q̇, q̈, u (..., nv); past ``MAX_MD_GRAD_NV`` velocity coordinates the two
gradients run through the staged pipeline, ``ops/kernels/multidof_staged``:
  * generalized inverse dynamics         → :func:`md_inverse_dynamics_batched`
  * generalized forward dynamics (ABA,
    or CRBA + Cholesky: ``impl="crba"``)  → :func:`md_forward_dynamics_batched`
  * tangent-space ∂ID                    → :func:`md_id_grad_batched`
  * tangent-space ∇FD                    → :func:`md_forward_dynamics_gradient_batched`

Floating base (a quaternion free flyer over a single-dof arm;
``ops/freeflyer``, ``ops/contact``), batched (..., d) states:
  * free-flyer FD (ABA, or the (6+n)² mass matrix and its Cholesky:
    ``impl="chol"``)                     → ``ops.freeflyer.fb_forward_dynamics_batched``
  * stance-constrained FD (k pinned
    contact points, Delassus solve)      → :func:`fb_constrained_fd_batched`
  * the frictional ground step (B
    environments, PGS friction cones)    → :func:`fb_step_ground_batched`
  * T ground steps                       → :func:`fb_simulate_ground_batched`
  * the step helpers                     → :func:`pd_torque`,
    :func:`clamp_effort`, :func:`joint_limit_torque`,
    :func:`project_joint_limits`, :func:`soft_contact_params`

The multi-dof ground step (``ops/md_contact``): B ball-hip / free-joint
robots on frictional ground, feet and ground-geom spheres →
:func:`md_step_ground_batched`.

Capsule and sphere geoms (``ops/collision``), the steppers'
``ground_geoms=`` and ``collision=`` (self and obstacle pairs):
:class:`Geoms`, :class:`Obstacles`, :class:`CollisionModel`,
:func:`make_geoms`, :func:`make_obstacles`, :func:`auto_pairs`,
:func:`make_collision_model`, :func:`n_ground_contacts`, and the pairs'
gaps, batch last, :func:`fb_collision_distances`. Loop closures
(``ops/loops``), the steppers' ``loops=``: their gaps, batch last,
:func:`fb_loop_gap`.

The MJCF front end (``models/mjcf``): :func:`parse_mjcf`,
:func:`mjcf_sites`, :func:`mjcf_actuators`, :func:`mjcf_loops`,
:func:`mjcf_welds`, :func:`mjcf_tendons`, :func:`mjcf_collision_model`,
:class:`MjcfSite`, :class:`MjcfActuation`, :class:`MjcfTendons`.

Heightfield terrain for the ground step (``ops/terrain``): :class:`Terrain`,
:func:`make_terrain`, :func:`flat_terrain`, :func:`slope_terrain`,
:func:`bumpy_terrain`, :func:`terrain_height_grad`,
:func:`terrain_surface`.
"""

from .api import (
    bias_force,
    direct_minv,
    forward_dynamics,
    forward_dynamics_gradient,
    forward_dynamics_gradient_full,
    forward_dynamics_hessian,
    forward_dynamics_hessian_vp,
    inverse_dynamics,
    inverse_dynamics_gradient,
)
from .models.robot import (RobotModel, from_jax_arrays, load_robot,
                           robot_model_from_description)
from .models.topology import Topology
from .ops.multidof import (
    MultiDofModel,
    md_forward_dynamics_batched,
    md_forward_dynamics_gradient_batched,
    md_from_jax_arrays,
    md_id_grad_batched,
    md_inverse_dynamics_batched,
    md_tangent_apply,
    multidof_model_from_description,
    neutral_q,
)
from .models.urdf import RobotDescription, parse_urdf
from .models.mjcf import (MjcfActuation, MjcfSite, MjcfTendons,
                          mjcf_actuators, mjcf_collision_model, mjcf_loops,
                          mjcf_sites, mjcf_tendons, mjcf_welds, parse_mjcf)
from .ops.collision import (
    CollisionModel,
    Geoms,
    Obstacles,
    auto_pairs,
    fb_collision_distances,
    make_collision_model,
    make_geoms,
    make_obstacles,
    n_ground_contacts,
)
from .ops.loops import fb_loop_gap
from .ops.md_contact import md_step_ground_batched
from .ops.contact import (
    clamp_effort,
    fb_constrained_fd_batched,
    fb_simulate_ground_batched,
    fb_step_ground_batched,
    joint_limit_torque,
    pd_torque,
    project_joint_limits,
    soft_contact_params,
)
from .ops.terrain import (
    Terrain,
    bumpy_terrain,
    flat_terrain,
    make_terrain,
    slope_terrain,
    terrain_height_grad,
    terrain_surface,
)
from .utils.golden import GoldenDynamics

__version__ = "0.1.0"

__all__ = [
    "RobotModel", "RobotDescription", "Topology", "GoldenDynamics",
    "load_robot", "parse_urdf", "parse_mjcf", "mjcf_collision_model",
    "mjcf_sites", "mjcf_actuators", "mjcf_loops", "mjcf_welds",
    "mjcf_tendons", "MjcfTendons", "MjcfSite", "MjcfActuation",
    "robot_model_from_description",
    "from_jax_arrays",
    "inverse_dynamics", "bias_force", "direct_minv", "forward_dynamics",
    "inverse_dynamics_gradient", "forward_dynamics_gradient",
    "forward_dynamics_gradient_full", "forward_dynamics_hessian",
    "forward_dynamics_hessian_vp",
    "MultiDofModel", "multidof_model_from_description", "md_from_jax_arrays",
    "neutral_q", "md_tangent_apply", "md_inverse_dynamics_batched",
    "md_forward_dynamics_batched", "md_id_grad_batched",
    "md_forward_dynamics_gradient_batched", "md_step_ground_batched",
    "fb_constrained_fd_batched",
    "fb_step_ground_batched", "fb_simulate_ground_batched", "pd_torque",
    "clamp_effort", "joint_limit_torque", "project_joint_limits",
    "soft_contact_params",
    "Terrain", "make_terrain", "flat_terrain", "slope_terrain",
    "bumpy_terrain", "terrain_height_grad", "terrain_surface",
    "Geoms", "Obstacles", "CollisionModel", "make_geoms", "make_obstacles",
    "auto_pairs", "make_collision_model", "n_ground_contacts",
    "fb_collision_distances", "fb_loop_gap",
]
