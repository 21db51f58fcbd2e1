#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gridcodegenerator_tpu_torch/ops/
kernels/csrc`` and runs, on ``cuda:0``:

0. a toolchain probe: the card's name and power limit, torch and its CUDA,
   nvcc, whether triton imports; then the kernel builds of seven
   single-dof robots (iiwa-14, the branched arm, Atlas, the route robots)
   and six multi-dof ones (the ball arm, free-joint iiwa-14, a mixed
   revolute/prismatic chain, free HyQ, a free-rooted 20-joint tree, free
   Atlas), with the staged multi-dof unit of every multi-dof robot the
   routes phase or phase 1 takes through it, and of three free flyers
   (HyQ, Atlas, a 3-link chain: the ABA and mass-matrix library and the
   stance library of their feet), and the ground steps' libraries (the md
   step of the ball ant from MJCF with and without its torso sphere and of
   free HyQ; HyQ's step with its ground geoms), all at once (nvcc seconds
   and ptxas's register / stack frame / spill report per kernel);
1. every kernel against its plain PyTorch version at a ragged B = 1000
   (the B = 4096 heads of phases 2 and A check the main-path kernels at a
   full tile), in float64 and float32: the single-kernel families on iiwa-14
   (a chain) and the branched arm (siblings under a moving parent); ABA on
   both and on Atlas; the staged kernels (K1, K2′ with and without a
   right-hand side, K4, the ∂ID vaf sweep, K5 with and without the finish)
   on Atlas (n = 28, a forest) and forced on the branched arm at a column
   block that leaves a ragged last block; the staged CTA tiles in every
   mode (``tile_pairs``: K5 with and without the finish, both sides and
   each alone, on full-precision and bf16 stage tensors; K2′ with and
   without a right-hand side; the sweep tile as K1, K4 on full-precision
   and bf16 v, and ∂ID's vaf) on HyQ, and on the branched arm and Atlas
   the modes the staged pairs leave out (TILE_EXTRA); the recursion ∇FD
   tile on iiwa-14, the branched arm (PAIRS' fd_grad) and the prismatic
   chain, each at a ragged last CTA; free HyQ's float32 step with its
   ground geoms on the 121² grid on the states of its own draws where the
   kernel failed the check while it contracted FMAs and divided by dt and
   the cell size where its plain version multiplies by their reciprocals
   (GEOMS_CASES, found by ``--geoms-fault``); the M⁻¹ and FD
   variants (the
   dense-M⁻¹ ∇FD and the composition FD on iiwa-14 and the branched arm;
   the factor-solve FD, K2 and K3, K2″, K4 and K5 reading bf16 stage
   tensors — also against the full-precision plain stages, 2e-2 — and K5
   one side a launch on Atlas and the branched arm, K3 there at its
   compiled width and at a ragged one); the second-order kernels; the
   five multi-dof kernels of md.cu on the ball arm, free iiwa-14, the mixed
   chain and free HyQ, and on the ball arm with armature; the staged
   multi-dof kernels (K1md with and without q̈, K2md with and without the
   bias force and q̈, K5md with and without the finish) and the CRBA FD on
   free Atlas, and forced on free iiwa-14 and the ball arm at column blocks
   that cut a free or ball joint; the free-flyer kernels of ff.cu (ABA,
   the mass-matrix FD, the stance FD plain and with Baumgarte, anchors and
   a Delassus ridge, the ground step flat and on a 121² and a 151² height
   grid, with and without a push, a soft contact and restitution, μ per
   environment and foot) on free-flyer HyQ, Atlas and the chain, and in
   float64 with armature; HyQ's step with its 14 ground-geom contacts
   (bench_contact.py:230-234) flat and on the 121² grid; the md step
   (md_step.cu) on the ball ant with its torso sphere, with softness,
   restitution and the knees' projected limits, with its feet only, and on
   free HyQ; the step's float32 checks leave out, and count, the states
   with a contact within 1e-5 of a switch, and the float64 checks with
   ground geoms the states whose plain version moves by more than 1e-13
   under ± 2e-16 input changes (near-duplicate contacts make the Delassus
   matrix rank-deficient there: such states are held one by one); then
   free HyQ's md step against its free-flyer step on 4096 float64 states
   (v⁺ and impulses, 1e-10); and the step with collision contacts and
   loop closures (ROWS_PHASE1, from a generator of their own): HyQ with
   the fat leg capsules and a sphere obstacle, with them and its ground
   geoms (24 contacts, 72 rows), with a push, a soft contact and
   restitution; the 3-link chain's base capsule in a self pair; the
   four-bar's closure and a world pin, flat and on the 121² grid — every
   case float64 and float32 with its round-off-sensitive states held one
   by one;
2. path iiwa-14: ``forward_dynamics_gradient`` and the three prefix
   families, float32, B = 2¹⁸ through the public API, its 256-state parity
   head against the float64 golden model (bench.py's protocol), each output
   against its plain version; path B: ``forward_dynamics`` (ABA) on iiwa-14
   at B = 2¹⁸;
A. path A, Atlas at B = 2¹⁸, float32: ``forward_dynamics_gradient``
   through the staged pipeline, then ``inverse_dynamics_gradient``,
   ``direct_minv``, ``inverse_dynamics``, ``bias_force`` and
   ``forward_dynamics``; launch counts, the 256-state ∇FD parity head beside
   the plain float32 version's head, each output and each stage kernel
   against its plain version;
H. the second-order paths at B = 2¹⁶ (iiwa-14, the double pendulum,
   Atlas's staged λᵀ·H);
3. times: the median of CUDA-event-timed calls of each kernel and of its
   plain version at its path's shape, the API times, and profiler
   breakdowns; each kernel's bound (the larger of its operations over the
   card's float32 rate and its bytes over its memory rate; operations as
   :class:`OpCount` counts them, in a child process on the CPU started
   after the builds, ``chip_smoke.py --count-ops``); ∇FD and λᵀ·H on
   both routes on either side of their joint-count limits; K2′'s library
   yardstick (``torch.linalg.cholesky_ex``, ``cholesky_inverse`` and
   ``cholesky_solve`` on the same CRBA matrices); the Atlas ∇FD profile in
   a child process (``chip_smoke.py --atlas-profile``);
M. the multi-dof paths at B = 2¹⁸, float32: free Atlas's tangent-space
   ∇FD and ∂ID through the staged multi-dof pipeline (the main path of
   the staged slice), its CRBA FD (``impl="crba"``), ID and ABA; free HyQ's
   ∇FD and ∂ID (staged too, past ``MAX_MD_GRAD_NV``); free iiwa-14's ∇FD
   and ∂ID and the ball arm's four families on the single-thread kernels —
   the launches of each call pinned to its route, its peak memory, each
   output's head against its plain version, and on the ∇FD robots
   ∂q̈/∂u·(u − c) against ABA, ∂q̈/∂δq and ∂q̈/∂q̇ against central
   differences of ABA, at free Atlas and free HyQ the staged ∇FD and ∂ID
   against the single-thread kernels, at free Atlas the CRBA FD against
   ABA (float64, 64 states); then the multi-dof kernels' times and bounds,
   free Atlas's K5md at three column widths, profiler breakdowns of its
   ∇FD and ∂ID by stage (in a child process), and both multi-dof gradient
   routes (∇FD and ∂ID) timed at 2¹⁶ from nv 7 to 34;
F. the free-flyer paths at B = 2¹⁸, float32, on HyQ (four feet) and Atlas
   (two feet): ``fb_forward_dynamics_batched`` (ABA, and ``impl="chol"``)
   and ``fb_constrained_fd_batched`` — one launch a call, peak memory, a
   256-state head of each output against its plain version, and in float64
   on 64 states ABA against the Cholesky FD and the stance solutions (with
   and without Baumgarte) against their constraint and dynamics equations;
   then the three kernels' times and bounds at both robots, the API times,
   the batched ``torch.linalg.cholesky`` + ``cholesky_solve`` pair on the
   same mass matrices (the profiler breakdowns of HyQ's stance and Atlas's
   ABA come from phase 3 ground step's child process);
S. the frictional ground step at B = 2¹⁸, float32, through
   ``fb_step_ground_batched`` (benchmarks/bench_contact.py's states, μ 0.8,
   30 sweeps): HyQ's four feet on the flat ground and on the bench's
   121² height grid, Atlas's two feet on the flat ground — one launch a
   call, a 256-state head against the plain version, the share of active
   feet; HyQ's 16-step rollout at 2¹⁶ (``fb_simulate_ground_batched``, one
   launch a step) against 16 single API steps, bit for bit; float64
   invariants on 4096 states of each free flyer (a unit quaternion, pn ≥ 0
   and 0 where inactive, the friction cone, a rollout equal to its steps);
   then the step kernels' times and bounds, API times and env-steps/s, and
   profiler breakdowns (in one child process: the free-flyer kernels',
   HyQ's two steps and the two cells below); then the
   multi-dof step through ``md_step_ground_batched`` on the ball ant (feet
   and torso sphere, μ 0.7 / 0.6, dt 2e-3; bench_contact.py:258-295) and
   HyQ's step with its ground geoms (bench_contact.py:225-256), 2¹⁸
   float32, one launch a call, heads against the plain versions, the
   active-contact shares, float64 invariants of the md step on 4096 ball-ant
   states (unit quaternions, pn ≥ 0 and 0 off contact, the friction cones
   with each contact's μ, the knees inside their projected limits), and
   both kernels' times, bounds, API times and frames; their profiles come
   from phase 3 ground step's child process (alone:
   ``chip_smoke.py --step-profile``); then the collision and loop cells
   through ``fb_step_ground_batched`` at 2¹⁸ float32 —
   collision_step_hyq (bench_contact.py:190-220: HyQ's feet, leg capsules
   and a sphere obstacle, 4 + 10 contacts, μ 0.8 / 0.5) and
   loop_ground_step_four_bar (bench_loops.py:84-115: the four-bar's feet
   and closure) — one launch a call, heads against the plain version, the
   active shares, float64 invariants on 4096 states (unit quaternions,
   pn ≥ 0 and 0 off contact, the cones with each contact's μ), the
   four-bar's 64-step rollout keeping its closure gap within twice the
   plain version's; and both cells' kernel, plain, bound, API times and
   env-steps/s (their profiles in the same child);
V. the fixed-base M⁻¹ and FD variants, float32, from a generator of their
   own: Atlas at 2¹⁴ and 2¹⁸ through bench_dense_minv.py's seven cases
   (dense, merged-K2″ and recursion ∇FD; K2′; M⁻¹ and FD on the
   single-thread kernels, its lane-recursion arms; the factor-solve FD),
   bench_bf16_staging.py's bf16 arm and the other options (per-side K5,
   the unfused finish, ∂ID per side and in bf16, ``minv_staged``,
   ``fd_staged``) — each call's launches pinned, the dense-vs-recursion
   and bf16-vs-full ∇FD parity —; iiwa-14 and HyQ ∇FD with ``minv_impl``
   recursion and dense at 2¹⁸ with their golden parity heads;
   ``forward_dynamics_fused`` against ABA on iiwa-14 and Atlas; each new
   kernel's time, plain time, bound and head against its plain version,
   and for the kernels that factor, the batched ``torch.linalg``
   Cholesky on the same CRBA matrices (the factor stage alone); the
   one-thread K1, K2′, K4, K5, vaf and recursion ∇FD that the CTA tiles
   replaced (``design("thread")``) as an arm: Atlas's dense ∇FD (full
   precision and bf16), ∂ID and M⁻¹ and iiwa-14's ∇FD on them, launches
   pinned, and each kernel's row (time, plain, bound, head).

``chip_smoke.py --tile-probe`` is the short first call for the tile
kernels: it builds staged.cu for the branched arm, HyQ and Atlas and
fused.cu for iiwa-14, the branched arm and the prismatic chain, prints
ptxas's report, holds the staged tiles in every mode and the recursion ∇FD
tile to their plain versions in float64 and float32, and times both
designs at Atlas f32, 2¹⁸ (the ∇FD at iiwa-14).
``chip_smoke.py --geoms-fault`` holds free HyQ's float32 step with its
ground geoms on the 121² grid to its plain version on 16,000 states of its
own draws, counts the states where the kernel is the plain version bit for
bit, and makes the same check on the plain version run with true division
(what one rounding does on an ill-conditioned state); it fails if the
kernel fails the check.

Each path runs with every launch count set to 0 just before it and read
just after. Imports no jax. Fails (non-zero exit, no result line) when
there is no CUDA device or any check fails. The second-to-last line is the
kernels' JSON record; the last is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu_torch.models import zoo
from gridcodegenerator_tpu_torch.ops import blops
from gridcodegenerator_tpu_torch.ops import so as tso
from gridcodegenerator_tpu_torch.ops.kernels import (_build, _launch, fused,
                                                    so_fused, so_staged,
                                                    staged)
from gridcodegenerator_tpu_torch.ops.kernels import multidof_fused as mdf
from gridcodegenerator_tpu_torch.ops.kernels import multidof_staged as mds
from gridcodegenerator_tpu_torch.ops import contact as tct
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops import terrain as ttr
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as cff
from gridcodegenerator_tpu_torch.ops.kernels import md_contact_fused as mdsf
from gridcodegenerator_tpu_torch.ops import md_blops as tmdb
from gridcodegenerator_tpu_torch.ops import md_contact as tmc

SEED = 0
ROWS_SEED = 1            # phase 1's collision and loop cases (phase1_rows)
TILE_SEED = 3            # phase 1's HyQ states for the K2′ and K5 tiles
MAIN_B = 1 << 18
PARITY_STATES = 256      # bench.py's parity head
COMPARE_STATES = 4096    # main-path kernel-vs-plain comparison
PARITY_MAX = 5e-6        # iiwa-14 f32 vs float64 golden, max over the head
# Atlas's head is held to the plain float32 version's on the same states:
# M(q) is worse conditioned at n = 28 than the 5e-6 bound assumes
ATLAS_HEAD_FACTOR = 2.0
# Kernel vs plain, as max|k − p| / max(1, max|p|) over each output tensor.
# float64: the same sums in the same order (FMA contraction aside), so the
# kernel must match its plain version to round-off. float32: both versions
# are held to the plain version run in float64 on the same inputs; the
# kernel's error must stay under 1e-5 or under twice the plain float32
# version's own error. A few ulps in X(q) move an ill-conditioned state's
# gradient by ~1e-5 in either version, so no float32 code meets a bare 1e-5
# on thousands of random states.
REL_TOL = {torch.float64: 1e-11, torch.float32: 1e-5}
F32_PLAIN_FACTOR = 2.0
TIMED_CALLS = 10
PHASE1_B = 1000            # ragged: not a multiple of the 128-thread block
# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores,
# and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FUSED_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/fused.cu"
STAGED_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/staged.cu"
SO_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/so.cu"
MD_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/md.cu"
MD_STAGED_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/md_staged.cu"
FF_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/ff.cu"
MD_STEP_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/md_step.cu"
# second order: 2¹⁶ states (e.g. 512 DDP rollouts × 128 knots); the plain
# versions are timed at a quarter of it and scaled
HESS_B = 1 << 16
PLAIN_SO_DIV = 4
HEAD_STATES = 4096       # second-order outputs held to their plain versions
ATLAS_SO_HEAD = 1024     # the staged λᵀ·H's plain pipeline at n = 28
SYM_MAX = 1e-3           # max|H − Hᵀ| / max(1, |H|): a layout fault is O(1)
TPU = "gridcodegenerator_tpu/ops/kernels/"
ROBOTS = {"iiwa14": zoo.iiwa14(), "branched_arm": zoo.branched_arm(),
          "atlas": zoo.atlas()}
FORCED_CB = 4   # the branched arm (n = 9) through K5 and T5: blocks 4, 4, 1
# robots whose ∇FD is timed on both routes, on either side of
# MAX_KERNEL_JOINTS (11): a seeded 11-joint tree (branched, M(q) condition
# ≤ 4e3 on random states) and HyQ, a forest of four 3-joint legs (the
# branched arm and seeded 10- and 16-joint trees, timed when the limit was
# placed, are in PERF.md). HyQ's λᵀ·H is timed on both routes too, and its
# full H at MAX_HESSIAN_JOINTS (12).
ROUTE_ROBOTS = {"tree11": zoo.random_tree(11, seed=3), "hyq": zoo.hyq()}
# while the routes are built, checked and timed, the single-thread kernels
# exist up to these joint counts whatever the routing limits are
ROUTE_LIMITS = {"MAX_KERNEL_JOINTS": 16, "MAX_HESSIAN_JOINTS": 12,
                "MAX_HESSIAN_VP_JOINTS": 12, "MAX_MD_GRAD_NV": 34}
# λᵀ·H on both routes, on either side of MAX_HESSIAN_VP_JOINTS (2): the
# double pendulum and a 5-joint chain; and HyQ for the full H
HESS_ROUTE_ROBOTS = {"dpend": zoo.double_pendulum(),
                     "chain5": zoo.serial_chain(5), "hyq": ROUTE_ROBOTS["hyq"]}
# the robot whose λᵀ·H phase H and phase 3 run on the single-thread kernel
# (the largest one under MAX_HESSIAN_VP_JOINTS)
SMALL_SO_ROBOT = "dpend"
ROUTE_SO_STATES = 1024   # the route checks' float64 states
# multi-dof: ball joints (the ball arm, nq 9, nv 7), a true 6-dof free joint
# at the root of iiwa-14 (n 8, nq 14, nv 13), of HyQ (n 13, nv 18), of a
# seeded 20-joint tree (n 21, nq 27, nv 26: between the two route robots
# below and above it) and of Atlas (n 29, nq 35, nv 34: the main path of
# the staged slice), and a mixed revolute / prismatic chain; damping 0.1 as
# in the JAX package's multi-dof tests (the tree's own)
MD_ROBOTS = {
    "ball_arm": zoo.ball_arm(damping=0.1),
    "free_iiwa14": zoo.with_free_joint(zoo.iiwa14(damping=0.1)),
    "mixed_chain": zoo.serial_chain(5, damping=0.1, prismatic_every=2),
    "free_hyq": zoo.with_free_joint(zoo.hyq(damping=0.1)),
    "free_tree20": zoo.with_free_joint(zoo.random_tree(20, seed=3)),
    "free_atlas": zoo.with_free_joint(zoo.atlas(damping=0.1)),
}
MD_CHECK = ("ball_arm", "free_iiwa14", "mixed_chain", "free_hyq")
MD_ARMATURE = 0.05       # the phase-1 armature case (the ball arm)
# the staged multi-dof kernels' phase-1 robots → K5md column width (None:
# the built one, 4 at free Atlas): 4 cuts free iiwa-14's root after its
# fourth direction, 2 the ball arm's first ball joint after its second
MD_STAGED_CHECK = {"free_atlas": None, "free_iiwa14": 4, "ball_arm": 2}
# both multi-dof gradient routes are built, checked and timed at these,
# on either side of MAX_MD_GRAD_NV
MD_ROUTE_ROBOTS = ("ball_arm", "free_iiwa14", "free_hyq", "free_tree20",
                   "free_atlas")
MD_ROUTE_B = 1 << 16     # the single-thread kernel's 92 KB frame at free Atlas
MD_CB_WIDTHS = (4, 3, 2)  # K5md with the finish, free Atlas
MD_FD_STATES = 64        # states of the finite-difference checks
MD_FD_STEP = 1e-6        # central-difference step (float64)
MD_FD_TOL = 1e-6         # ∇FD vs central differences, relative
MD_SOLVE_TOL = 1e-8      # ∂q̈/∂u·(u − c) vs ABA's q̈, relative
# the staged ∇FD and ∂ID against the single-thread kernels on the same
# float64 states (the staged q̈ is an explicit M⁻¹ product, not the
# Cholesky solve): the JAX package's bound for the same comparison
MD_ROUTE_TOL = 1e-9
# free flyers: label → (URDF, contact links, each foot's body-frame offset,
# the joints' mean posture, their spread). HyQ with damping 0.2 and its four
# feet 0.35 m down each shank (the JAX package's contact tests and
# bench_contact.py); Atlas's two feet at l_leg_akx and r_leg_akx, the last
# joint of each leg; the JAX package's small free-flyer chain, one contact
# on its last link
FF_ROBOTS = {
    "hyq": (zoo.hyq(damping=0.2), (2, 5, 8, 11), (0.35, 0.0, 0.0),
            (-0.1, 0.7, -1.2), 0.1),
    "atlas": (zoo.atlas(damping=0.1), (21, 27), (0.05, 0.0, -0.05),
              (0.0,), 0.5),
    "chain3": (zoo.serial_chain(3, damping=0.1), (2,), (0.1, 0.0, 0.0),
               (0.0,), 0.3),
    # the four-bar as a free flyer (bench_loops.py:84-115): feet on the
    # rocker (link 2) and the crank (link 0), 0.25 m down each
    "four_bar": (zoo.four_bar(damping=0.05), (2, 0), (0.0, 0.0, -0.25),
                 (0.0,), 0.2),
}
# the free flyers every ff.cu kernel is checked on (the four-bar only in
# the collision and loop cases)
FF_CHECK = ("hyq", "atlas", "chain3")
FF_PATHS = ("hyq", "atlas")   # phase F, float32 at MAIN_B
FF_ARMATURE = 0.05
# the stance's second case (the JAX package's interpret-mode test): explicit
# anchors ± 0.1 m, Baumgarte (α, β) = (3, 2) and a Delassus ridge
FF_BAUMGARTE = {"baumgarte": (3.0, 2.0), "reg": 1e-10}
FF_PHYS_STATES = 64
FF_ABA_CHOL_TOL = 1e-11  # ABA vs the mass-matrix Cholesky, float64
FF_CON_TOL = 1e-9        # J·y + J̇v − a*, relative (+ reg·|λ| with a ridge)
FF_DYN_TOL = 1e-10       # M·y − [−f_b; τ − c_j] − Jᵀλ, relative
# the ground step (benchmarks/bench_contact.py's shape): dt 1e-3, μ 0.8, 30
# PGS sweeps; erp 0.2 and margin 1e-3 are the defaults
STEP_DT = 1e-3
STEP_MU = 0.8
STEP_ITERS = 30
STEP_MARGIN = 1e-3
# height grids: bench_contact.py's bumpy ground (121 × 121 nodes) and one of
# 151 × 151 past the JAX package's VMEM gate (tests/test_contact_fused.py)
STEP_GRIDS = {"121": dict(amp=0.04, wavelength=1.1, extent=6.0, cell=0.1),
              "151": dict(amp=0.04, wavelength=1.2, extent=6.0, cell=0.08)}
# phase 1's step cases: name → (grid or None, with the options: a push of ±
# STEP_PUSH, a soft contact (soft_contact_params(kp, kd, dt)) and
# restitution); μ is drawn per environment and foot
STEP_CASES = {"step_ground": (None, False),
              "step_ground_soft": (None, True),
              "step_ground_terrain": ("121", False),
              "step_ground_terrain_151_soft": ("151", True)}
STEP_PUSH = 20.0
STEP_SOFT = (5e4, 2e3)
STEP_RESTITUTION = 0.3
# float32 checks leave out the states where a foot's float64 gap is within
# this of the margin, or the foot within this many cells of a cell edge:
# a switch there moves the state's impulses by O(1) in either version
STEP_SWITCH = 1e-5
# phase S: cell → (robot, grid or None). HyQ in bench_contact.py's states
# (its feet 0.15 m into the ground: all four active); Atlas at the height
# that puts its feet 1 cm into the ground at the zero posture
STEP_PATHS = {"hyq": ("hyq", None), "hyq_terrain": ("hyq", "121"),
              "atlas": ("atlas", None)}
STEP_DEPTH = {"hyq": None, "atlas": 0.01}
STEP_POSTURE_SPREAD = 0.05
ROLLOUT_T = 16
ROLLOUT_B = 1 << 16      # bench_contact.py's rollout shape
STEP_INV_STATES = 4096   # the float64 invariants, each robot
STEP_INV_T = 4
QUAT_TOL = 1e-12         # | ‖quat⁺‖ − 1 |
CONE_TOL = 1e-9          # ‖pt‖ ≤ μ·pn + CONE_TOL
STEP_OPS_STATES = 16     # the bound's operations, averaged over these
# HyQ's ground geoms (bench_contact.py:230-234): a torso capsule on the
# base and a capsule along each shin, 4 + 10 contacts; their μ_ground
STEP_GEOMS = dict(links=(-1, 2, 5, 8, 11),
                  a=[[-0.35, 0.0, -0.02]] + [[0.0, 0.0, 0.0]] * 4,
                  b=[[0.35, 0.0, -0.02]] + [[0.3, 0.0, 0.0]] * 4,
                  r=[0.18, 0.03, 0.03, 0.03, 0.03])
STEP_MU_GROUND = 0.6
# the checks of a step with ground geoms hold each round-off-sensitive state
# on its own: one whose plain float64 version moves by more than REL_TOL /
# SENS_MARGIN of the checked dtype when its inputs move by ± about one ulp
# of that dtype (SENS_ULP, relative; the largest move of SENS_DRAWS random
# draws). Near-duplicate contacts (a shin tip beside its foot) make the
# Delassus G rank-deficient, and the PGS sweeps then amplify round-off, so
# no two orderings of the same sums agree there to REL_TOL. Such a state's
# error may reach SENS_C times its measured sensitivity (in float32 the
# larger of that and the plain float32 version's own error there); every
# other state takes the normwise check.
SENS_ULP = {torch.float64: 2e-16, torch.float32: 6e-8}
SENS_DRAWS = 8
SENS_MARGIN = 10.0
SENS_C = 10.0
# the multi-dof step (bench_contact.py:258-295): the ball ant from MJCF
# (free joint, four ball hips, four hinge knees; nq 27, nv 22), its four
# foot sites and its torso sphere (r 0.18, μ_ground 0.6), dt 2e-3, μ 0.7
MD_STEP_DT = 2e-3
MD_STEP_MU = 0.7
MD_TORSO = dict(links=(0,), a=[[0.0, 0.0, 0.0]], r=0.18)
# phase 1's md cases: name → (robot, with the torso sphere, with softness
# + restitution + the knees' projected limits)
MD_STEP_CASES = {"md_step_ground": ("ball_ant", True, False),
                 "md_step_ground_soft_limits": ("ball_ant", True, True),
                 "md_step_ground_feet": ("ball_ant", False, False),
                 "md_step_ground_free_hyq": ("free_hyq", False, False)}
MD_KNEE_LIMITS = (0.2, 1.2)   # each knee's range in the limits case
# collision sets: name → (geoms (links, a, b, r), obstacles (a, r) or None,
# self pairs or None for auto_pairs at min_separation 2). "bench" is
# collision_step_hyq's (bench_contact.py:190-220: HyQ's leg capsules r
# 0.12 and a sphere obstacle r 0.3, 4 + 10 contacts), "fat" the JAX
# package's test set (tests/test_contact_fused.py:327-337: r 0.24 and
# 0.35, self and obstacle pairs both active), "base_pair" the 3-link
# chain's base capsule against a sphere on its last link
COLL_SETS = {
    "bench": (((2, 5, 8, 11), [[0.0, 0.0, 0.0]] * 4, [[0.3, 0.0, 0.0]] * 4,
               0.12), ([[0.25, 0.05, 0.1]], 0.3), None),
    "fat": (((2, 5, 8, 11), [[0.0, 0.0, 0.0]] * 4, [[0.3, 0.0, 0.0]] * 4,
             0.24), ([[0.25, 0.05, 0.1]], 0.35), None),
    "base_pair": (((-1, 2), [[-0.1, 0.0, -0.05], [0.1, 0.0, 0.0]],
                   [[0.2, 0.0, -0.05], [0.1, 0.0, 0.0]], [0.15, 0.12]),
                  None, ((0, 1),)),
}
COLL_MU = 0.5            # μ_collision (bench_contact.py:207)
# loop closures: name → (pairs, offsets_a, offsets_b) on the four-bar
# (crank 0, coupler 1, rocker 2). "bench" the closure coupler ↔ rocker
# (bench_loops.py); "pin" adds a world pin of the crank's tip
# (tests/test_contact_fused.py:370-378)
LOOP_SETS = {
    "bench": (((1, 2),), [[0.8, 0.0, 0.0]], [[0.0, 0.0, -0.5]]),
    "pin": (((1, 2), (0, -1)), [[0.8, 0.0, 0.0], [0.0, 0.0, -0.25]],
            [[0.0, 0.0, -0.5], [0.1, 0.0, 0.15]]),
}
# the collision and loop cases: name → (robot, collision set, with HyQ's
# ground geoms, loop set, grid, with a push, a soft contact and
# restitution). Phase 1 holds each to its plain version (float64 and
# float32, round-off-sensitive states one by one); phase S times the two
# cells ROWS_PATHS on the entry point
ROWS_CASES = {
    "hyq_collision": ("hyq", "fat", False, None, None, False),
    "hyq_collision_geoms": ("hyq", "fat", True, None, None, False),
    "hyq_collision_options": ("hyq", "fat", False, None, None, True),
    "chain3_base_pair": ("chain3", "base_pair", False, None, None, False),
    "four_bar_loops": ("four_bar", None, False, "pin", None, False),
    "four_bar_loops_terrain": ("four_bar", None, False, "pin", "121", False),
    "collision_step_hyq": ("hyq", "bench", False, None, None, False),
    "loop_ground_step_four_bar": ("four_bar", None, False, "bench", None,
                                  False),
}
ROWS_PHASE1 = ("hyq_collision", "hyq_collision_geoms",
               "hyq_collision_options", "chain3_base_pair", "four_bar_loops",
               "four_bar_loops_terrain")
ROWS_PATHS = ("collision_step_hyq", "loop_ground_step_four_bar")
LOOP_ROLLOUT_T = 64      # the four-bar's closure check
LOOP_GAP_FACTOR = 2.0    # the kernel's closure gap ≤ this × the plain's
MD_CROSS_STATES = 4096   # md step vs the free-flyer step, float64
MD_CROSS_TOL = 1e-10


@contextmanager
def route_limits():
    saved = {k: getattr(_build, k) for k in ROUTE_LIMITS}
    for k, v in ROUTE_LIMITS.items():
        setattr(_build, k, max(v, saved[k]))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(_build, k, v)


def log(*a):
    print(*a, flush=True)


def card():
    """``name, power.limit`` as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def uniform_states(n, B, dtype, gen, layout="nB"):
    """q ∈ [−2, 2], q̇ ∈ [−1, 1], u ∈ [−8, 8] (bench.py's ranges)."""
    shape = (n, B) if layout == "nB" else (B, n)
    out = []
    for r in (2.0, 1.0, 8.0):
        x = torch.rand(shape, generator=gen, device="cuda", dtype=dtype)
        out.append(x * (2 * r) - r)
    return out


def _bias_kernel(m, q, qd):
    return fused.inverse_dynamics_fused(m, q, qd, None)


def _bias_plain(m, q, qd):
    return fused.inverse_dynamics_plain(m, q, qd, None)


# name → (LAUNCHES key, kernel wrapper, plain version, number of (n, B)
# state inputs); bias_force is the qdd=None variant of the RNEA kernel
PAIRS = {
    "fd_grad": ("fd_grad", fused.fd_grad_fused, fused.fd_grad_plain, 3),
    "id_grad": ("id_grad", fused.id_grad_fused, fused.id_grad_plain, 3),
    "minv": ("minv", fused.minv_fused, fused.minv_plain, 1),
    "inverse_dynamics": ("inverse_dynamics", fused.inverse_dynamics_fused,
                         fused.inverse_dynamics_plain, 3),
    "bias_force": ("inverse_dynamics", _bias_kernel, _bias_plain, 2),
}
ABA = ("aba", fused.forward_dynamics_aba_fused,
       fused.forward_dynamics_aba_plain, 3)


def staged_pairs(cb=None):
    """The staged kernels as (LAUNCHES key, kernel, plain, inputs): each
    stage's inputs are (q, q̇, u) and the plain upstream stages' outputs,
    so every kernel is held to its plain version on identical inputs."""
    def up(m, q, qd, u):
        c, v = staged.bias_and_v_plain(m, q, qd)
        Minv, qdd = staged.minv_qdd_dense_plain(m, q, u - c)
        a, f = staged.af_plain(m, q, qd, qdd, v)
        v2, a2, f2 = staged.vaf_plain(m, q, qd, u)
        return dict(c=c, v=v, Minv=Minv, qdd=qdd, a=a, f=f, v2=v2, a2=a2,
                    f2=f2)

    return up, {
        "bias_and_v": ("bias_and_v", staged.bias_and_v_staged,
                       staged.bias_and_v_plain, lambda s, x: (s[0], s[1])),
        "minv_dense": ("minv_dense", staged.minv_qdd_dense_staged,
                       staged.minv_qdd_dense_plain,
                       lambda s, x: (s[0], s[2] - x["c"])),
        "minv_dense_norhs": ("minv_dense", staged.minv_qdd_dense_staged,
                             staged.minv_qdd_dense_plain,
                             lambda s, x: (s[0],)),
        "af": ("af", staged.af_staged, staged.af_plain,
               lambda s, x: (s[0], s[1], x["qdd"], x["v"])),
        "vaf": ("vaf", staged.vaf_staged, staged.vaf_plain,
                lambda s, x: (s[0], s[1], s[2])),
        "grad_cols_finish": (
            "grad_cols_finish",
            lambda m, *a: staged.grad_cols_staged(m, *a[:5], cb=cb,
                                                  Minv=a[5]),
            lambda m, *a: staged.grad_cols_plain(m, *a[:5], cb=cb,
                                                 Minv=a[5]),
            lambda s, x: (s[0], s[1], x["v"], x["a"], x["f"], x["Minv"])),
        "grad_cols": (
            "grad_cols",
            lambda m, *a: staged.grad_cols_staged(m, *a, cb=cb),
            lambda m, *a: staged.grad_cols_plain(m, *a, cb=cb),
            lambda s, x: (s[0], s[1], x["v2"], x["a2"], x["f2"])),
    }


# the fused.cu variants (minv_impl="dense", the composition FD): name →
# (LAUNCHES key, kernel, plain, inputs); built and routed up to
# MAX_KERNEL_JOINTS
VARIANT_PAIRS = {
    "fd_grad_dense": (
        "fd_grad_dense",
        lambda m, *s: fused.fd_grad_fused(m, *s, minv_impl="dense"),
        lambda m, *s: fused.fd_grad_plain(m, *s, minv_impl="dense"), 3),
    "fd": ("fd", fused.forward_dynamics_fused, fused.forward_dynamics_plain,
           3),
}


def variant_pairs(cb=None, mcb=None):
    """The staged.cu variants as (LAUNCHES key, kernel, plain, inputs), on
    the plain upstream stages' outputs like staged_pairs: the factor-solve
    FD, K2 and K3 (K3 at column width ``mcb``), K2″, K4 and K5 reading bf16
    stage tensors (staged.to_stage of the plain stages'), and K5 one side
    a launch (the ∇FD's ∂/∂q̇ side with the finish; the ∂ID's ∂/∂q side)."""
    def up(m, q, qd, u):
        c, v = staged.bias_and_v_plain(m, q, qd)
        Minv, qdd = staged.minv_qdd_dense_plain(m, q, u - c)
        a, f = staged.af_plain(m, q, qd, qdd, v)
        U, Dinv = staged.minv_ud_plain(m, q)
        v2, a2, f2 = staged.vaf_plain(m, q, qd, u)
        x = dict(umc=u - c, v=v, Minv=Minv, qdd=qdd, a=a, f=f, U=U,
                 Dinv=Dinv, v2=v2, a2=a2, f2=f2)
        x.update({f"{k}16": staged.to_stage(x[k])
                  for k in ("v", "a", "f", "Minv", "v2", "a2", "f2")})
        return x

    def k5(sides, finish):
        def kern(m, *a):
            return staged.grad_cols_staged(
                m, *a[:5], cb=cb, Minv=a[5] if finish else None, sides=sides)

        def plain(m, *a):
            return staged.grad_cols_plain(
                m, *a[:5], cb=cb, Minv=a[5] if finish else None, sides=sides)
        return kern, plain

    both, fin16, raw16 = ("q", "qd"), "grad_cols_finish_bf16", "grad_cols_bf16"
    return up, {
        "fd_dense": ("fd_dense", staged.fd_dense_staged,
                     staged.fd_dense_plain, lambda s, x: tuple(s)),
        "minv_ud": ("minv_ud", staged.minv_ud_staged, staged.minv_ud_plain,
                    lambda s, x: (s[0],)),
        "minv_cols": (
            "minv_cols",
            lambda m, *a: staged.minv_cols_staged(m, *a, cb=mcb),
            lambda m, *a: staged.minv_cols_plain(m, *a, cb=mcb),
            lambda s, x: (s[0], x["U"], x["Dinv"])),
        "minv_af": ("minv_af", staged.minv_qdd_af_dense_staged,
                    staged.minv_af_plain,
                    lambda s, x: (s[0], s[1], x["umc"], x["v"])),
        "af_bf16": ("af_bf16", staged.af_staged, staged.af_plain,
                    lambda s, x: (s[0], s[1], x["qdd"], x["v16"])),
        fin16: (fin16, *k5(both, True),
                lambda s, x: (s[0], s[1], x["v16"], x["a16"], x["f16"],
                              x["Minv16"])),
        raw16: (raw16, *k5(both, False),
                lambda s, x: (s[0], s[1], x["v216"], x["a216"], x["f216"])),
        "grad_cols_finish_side": (
            "grad_cols_finish_side", *k5(("qd",), True),
            lambda s, x: (s[0], s[1], x["v"], x["a"], x["f"], x["Minv"])),
        "grad_cols_side": (
            "grad_cols_side", *k5(("q",), False),
            lambda s, x: (s[0], s[1], x["v2"], x["a2"], x["f2"])),
    }


def tile_pairs():
    """The staged tiles in every mode as (LAUNCHES key, kernel, plain,
    inputs), on the plain upstream stages' outputs like staged_pairs: K5
    with the finish and without (the ∂ID's sweep), both sides and each side
    alone, on full-precision and bf16 stage tensors; K2′ with and without a
    right-hand side; the sweep tile as K1, K4 (v in the model's dtype and
    in bf16) and ∂ID's vaf. Names: the LAUNCHES key, then the side of a
    one-side launch."""
    up, _ = variant_pairs()

    def k5(sides, fin, s16):
        t = "16" if s16 else ""
        if fin:
            def inputs(st, x):
                return (st[0], st[1], *(x[k + t] for k in ("v", "a", "f",
                                                           "Minv")))
        else:
            def inputs(st, x):
                return (st[0], st[1], *(x[k + t] for k in ("v2", "a2",
                                                           "f2")))

        def kern(m, *a):
            return staged.grad_cols_staged(
                m, *a[:5], Minv=a[5] if fin else None, sides=sides)

        def plain(m, *a):
            return staged.grad_cols_plain(
                m, *a[:5], Minv=a[5] if fin else None, sides=sides)
        return kern, plain, inputs

    out = {}
    for fin in (True, False):
        for sides in (("q", "qd"), ("q",), ("qd",)):
            for s16 in (False, True):
                key = (("grad_cols_finish" if fin else "grad_cols")
                       + ("_side" if len(sides) == 1 else "")
                       + ("_bf16" if s16 else ""))
                name = key + ("" if len(sides) == 2 else f"_{sides[0]}")
                out[name] = (key, *k5(sides, fin, s16))
    out["minv_dense"] = ("minv_dense", staged.minv_qdd_dense_staged,
                         staged.minv_qdd_dense_plain,
                         lambda st, x: (st[0], x["umc"]))
    # the sweep tile: K1, K4 on full-precision and bf16 v, ∂ID's vaf
    out["bias_and_v"] = ("bias_and_v", staged.bias_and_v_staged,
                         staged.bias_and_v_plain, lambda st, x: st[:2])
    for key, v in (("af", "v"), ("af_bf16", "v16")):
        out[key] = (key, staged.af_staged, staged.af_plain,
                    lambda st, x, v=v: (st[0], st[1], x["qdd"], x[v]))
    out["vaf"] = ("vaf", staged.vaf_staged, staged.vaf_plain,
                  lambda st, x: tuple(st))
    out["minv_dense_norhs"] = ("minv_dense", staged.minv_qdd_dense_staged,
                               staged.minv_qdd_dense_plain,
                               lambda st, x: (st[0],))
    return up, out


# the K5 modes phase 1 adds on the robots staged_pairs and variant_pairs
# already cover: each side alone with and without the finish, and (on the
# branched arm) on bf16 stage tensors
TILE_EXTRA = {"branched_arm": ("grad_cols_finish_side_q", "grad_cols_side_qd",
                               "grad_cols_finish_side_bf16_q",
                               "grad_cols_side_bf16_qd"),
              "atlas": ("grad_cols_finish_side_q", "grad_cols_side_qd")}
TILE_ROBOT = "hyq"   # phase 1 holds it in every mode of tile_pairs


def uniform_lam(n, B, dtype, gen, layout="nB"):
    """λ ∈ [−1, 1] (a DDP value gradient's scale)."""
    shape = (n, B) if layout == "nB" else (B, n)
    return torch.rand(shape, generator=gen, device="cuda", dtype=dtype) * 2 - 1


# the single-thread second-order kernels: name → (LAUNCHES key, kernel,
# plain, inputs from (q, q̇, u, λ))
HESS_PAIRS = {
    "hessian_vp": ("hessian_vp", so_fused.fd_hessian_vp_fused,
                   so_fused.fd_hessian_vp_plain, 4),
    "hessian": ("hessian", so_fused.fd_hessian_fused,
                so_fused.fd_hessian_plain, 3),
}


def so_stage_pairs(cb=None):
    """The staged λᵀ·H's tangent stages as (LAUNCHES key, kernel, plain,
    inputs): each stage's inputs are (q, q̇, u, λ) and the plain upstream
    stages' outputs, so every kernel is held to its plain version on
    identical inputs. The variants of T1, T4 (q- or q̇-directions) and T5
    (and the side of ∂c) are those the pipeline runs."""
    def up(m, q, qd, u, lam):
        c, v = staged.bias_and_v_plain(m, q, qd)
        Minv, qdd = staged.minv_qdd_dense_plain(m, q, u - c)
        a, f = staged.af_plain(m, q, qd, qdd, v)
        x = dict(v=v, a=a, f=f, Minv=Minv, qdd=qdd,
                 lamM=torch.einsum("ijb,jb->ib", Minv, lam))
        for w in (0, 1):
            x[f"dc{w}"], x[f"dv{w}"] = so_staged.t1_plain(m, q, qd, w)
        x["dlamM"], x["dqdd0"] = so_staged.t2_plain(m, q, x["lamM"], qdd,
                                                    Minv, x["dc0"])
        x["dqdd1"] = -torch.einsum("ijb,djb->dib", Minv, x["dc1"])
        for w in (0, 1):
            x[f"da{w}"], x[f"df{w}"] = so_staged.t4_plain(
                m, q, qd, qdd, v, x[f"dv{w}"], x[f"dqdd{w}"], w)
        return {k: t.contiguous() for k, t in x.items()}

    def t1(w):
        return ("t1", lambda m, q, qd: so_staged.t1_staged(m, q, qd, w),
                lambda m, q, qd: so_staged.t1_plain(m, q, qd, w),
                lambda s, x: (s[0], s[1]))

    def t4(w):
        return ("t4", lambda m, *a: so_staged.t4_staged(m, *a, w),
                lambda m, *a: so_staged.t4_plain(m, *a, w),
                lambda s, x: (s[0], s[1], x["qdd"], x["v"], x[f"dv{w}"],
                              x[f"dqdd{w}"]))

    def t5(w, side):
        return ("t5",
                lambda m, *a: so_staged.t5_staged(m, *a, w, side, cb=cb),
                lambda m, *a: so_staged.t5_plain(m, *a, w, side, cb=cb),
                lambda s, x: (s[0], s[1], x["v"], x["a"], x["f"], x["lamM"],
                              x[f"dv{w}"], x[f"da{w}"], x[f"df{w}"]))

    return up, {
        "t1_q": t1(0), "t1_qd": t1(1),
        "t2": ("t2", so_staged.t2_staged, so_staged.t2_plain,
               lambda s, x: (s[0], x["lamM"], x["qdd"], x["Minv"],
                             x["dc0"])),
        "t4_q": t4(0), "t4_qd": t4(1),
        "t5_q_q": t5(0, "q"), "t5_q_qd": t5(0, "qd"), "t5_qd_qd": t5(1, "qd"),
    }


def _t5_primal(side, cb=None):
    """One side's ∂c rows of every column block contracted with lamM: the
    function T5 differentiates, for its bound."""
    def primal(m, q, qd, v, a, f, lamM, *_):
        X = blops.joint_transforms_bl(m, q)
        vl, al, fl = (staged._as_list(t, m.n) for t in (v, a, f))
        width = so_staged._so_col_block(m, cb)
        for c0, w in staged._blocks(m.n, width):
            rows = blops.rnea_grad_cols_bl(m, X, qd, vl, al, fl, c0=c0, cb=w,
                                           sides=(side,), as_rows=True)[side]
            sum(lamM[i:i + 1] * r for i, r in enumerate(rows)
                if r is not None)
    return primal


# the function each second-order kernel differentiates, once per state (its
# operations are counted once in the bound, not once per direction): name →
# (primal, directions a state)
SO_PRIMALS = {
    "hessian_vp": (lambda m, q, qd, u, lam: tso.fd_grad_full_bl(m, q, qd, u),
                   3),
    "hessian": (tso.fd_grad_full_bl, 3),
    "t1_q": (staged.bias_and_v_plain, 1),
    "t2": (lambda m, q, lamM, qdd, *_: so_staged.crba_matvecs(
        m, blops.joint_transforms_bl(m, q), (lamM, qdd)), 1),
    "t4_q": (lambda m, q, qd, qdd, v, *_: staged.af_plain(m, q, qd, qdd, v),
             1),
    "t5_q_q": (_t5_primal("q"), 1),
}


# the multi-dof kernels of md.cu: name → (LAUNCHES key, kernel, plain,
# number of (q, q̇, u) inputs); u stands for q̈ in ID and ∂ID, and two inputs
# are the qdd=None variants (the bias force; ∂ID at q̈ = 0)
MD_PAIRS = {
    "md_id": ("md_id", mdf.md_id_fused, mdf.md_id_plain, 3),
    "md_bias": ("md_id", mdf.md_id_fused, mdf.md_id_plain, 2),
    "md_aba": ("md_aba", mdf.md_aba_fused, mdf.md_aba_plain, 3),
    "md_fd": ("md_fd", mdf.md_fd_fused, mdf.md_fd_plain, 3),
    "md_id_grad": ("md_id_grad", mdf.md_id_grad_fused, mdf.md_id_grad_plain,
                   3),
    "md_id_grad_noqdd": ("md_id_grad", mdf.md_id_grad_fused,
                         mdf.md_id_grad_plain, 2),
    "md_fd_grad": ("md_fd_grad", mdf.md_fd_grad_fused, mdf.md_fd_grad_plain,
                   3),
}


def md_staged_pairs(cb=None):
    """The staged multi-dof kernels as (LAUNCHES key, kernel, plain,
    inputs): each stage's inputs are (q, q̇, u) and the plain upstream
    stages' outputs, so every kernel is held to its plain version on
    identical inputs; ∂ID's K1md and K5md take u as q̈."""
    def up(m, q, qd, u):
        Minv, qdd = mds.md_minv_qdd_plain(m, q, qd, u)
        v, a, f = mds.md_vaf_plain(m, q, qd, qdd)
        v2, a2, f2 = mds.md_vaf_plain(m, q, qd, u)
        return dict(Minv=Minv, qdd=qdd, v=v, a=a, f=f, v2=v2, a2=a2, f2=f2)

    return up, {
        "md_minv_qdd": ("md_minv_qdd", mds.md_minv_qdd_fused,
                        mds.md_minv_qdd_plain, lambda s, x: s),
        "md_minv": ("md_minv", mds.md_minv_fused, mds.md_minv_plain,
                    lambda s, x: (s[0],)),
        "md_vaf": ("md_vaf", mds.md_vaf_staged, mds.md_vaf_plain,
                   lambda s, x: (s[0], s[1], x["qdd"])),
        "md_vaf_noqdd": ("md_vaf", mds.md_vaf_staged, mds.md_vaf_plain,
                         lambda s, x: (s[0], s[1])),
        "md_grad_cols_finish": (
            "md_grad_cols_finish",
            lambda m, *a: mds.md_grad_cols_staged(m, *a[:5], cb=cb,
                                                  Minv=a[5]),
            lambda m, *a: mds.md_grad_cols_plain(m, *a[:5], cb=cb,
                                                 Minv=a[5]),
            lambda s, x: (s[0], s[1], x["v"], x["a"], x["f"], x["Minv"])),
        "md_grad_cols": (
            "md_grad_cols",
            lambda m, *a: mds.md_grad_cols_staged(m, *a, cb=cb),
            lambda m, *a: mds.md_grad_cols_plain(m, *a, cb=cb),
            lambda s, x: (s[0], s[1], x["v2"], x["a2"], x["f2"])),
    }


def _md_crba(m, q, qd, u):
    return gt.md_forward_dynamics_batched(m, q, qd, u, impl="crba")


# the batched entry points: family → (entry, number of (q, q̇, u) inputs)
MD_API = {
    "id": (gt.md_inverse_dynamics_batched, 3),
    "aba": (gt.md_forward_dynamics_batched, 3),
    "crba": (_md_crba, 3),
    "id_grad": (gt.md_id_grad_batched, 3),
    "fd_grad": (gt.md_forward_dynamics_gradient_batched, 3),
}


def md_route(m, fam):
    """(the launches one call of ``fam`` makes on ``m``, its plain
    version, its batch-last kernel function): the gradient families on the
    single-thread kernels up to MAX_MD_GRAD_NV, on the staged pipeline
    past it."""
    dense = _build.md_dense_grads(m.nv)
    return {
        "id": ({"md_id": 1}, mdf.md_id_plain, mdf.md_id_fused),
        "aba": ({"md_aba": 1}, mdf.md_aba_plain, mdf.md_aba_fused),
        "crba": ({"md_fd": 1}, mdf.md_fd_plain, mdf.md_fd_fused),
        "id_grad": (({"md_id_grad": 1}, mdf.md_id_grad_plain,
                     mdf.md_id_grad_fused) if dense else
                    ({"md_vaf": 1, "md_grad_cols": 1},
                     mds.md_id_grad_staged_plain, mds.md_id_grad_staged)),
        "fd_grad": (({"md_fd_grad": 1}, mdf.md_fd_grad_plain,
                     mdf.md_fd_grad_fused) if dense else
                    ({"md_minv_qdd": 1, "md_vaf": 1,
                      "md_grad_cols_finish": 1},
                     mds.md_fd_grad_staged_plain, mds.md_fd_grad_staged)),
    }[fam]


# phase M: robot → the families driven through the API at MAIN_B, the
# staged slice's main path (free Atlas's gradients) first
MD_PATHS = {
    "free_atlas": ("fd_grad", "id_grad", "crba", "id", "aba"),
    "free_iiwa14": ("fd_grad", "id_grad"),
    "free_hyq": ("fd_grad", "id_grad"),
    "ball_arm": ("id", "aba", "id_grad", "fd_grad"),
}


def md_model(label, dtype=torch.float32, armature=None, device="cuda"):
    desc = gt.parse_urdf(MD_ROBOTS[label])
    if armature is not None:
        desc = dataclasses.replace(desc, armature=np.full(desc.n, armature))
    return gt.multidof_model_from_description(desc, dtype=dtype,
                                              device=device)


def md_states(m, B, gen, layout="nB"):
    """The JAX package's multi-dof states: neutral_q ⊕ a tangent step in
    [−0.6, 0.6], q̇ ∈ [−0.8, 0.8], u ∈ [−5, 5]; q (nq, B), the others
    (nv, B), or batch first."""
    def uni(r):
        return (torch.rand((B, m.nv), generator=gen, device="cuda",
                           dtype=m.dtype) * (2 * r) - r)
    q = gt.md_tangent_apply(m, gt.neutral_q(m).expand(B, -1), uni(0.6))
    out = [q, uni(0.8), uni(5.0)]
    return out if layout == "Bn" else [x.T.contiguous() for x in out]


def ff_model(label, dtype=torch.float32, armature=None, device="cuda"):
    desc = gt.parse_urdf(FF_ROBOTS[label][0])
    if armature is not None:
        desc = dataclasses.replace(desc, armature=np.full(desc.n, armature))
    return tff.free_flyer_model(desc, dtype=dtype, device=device)


def ff_states(m, B, gen, label, layout="dB"):
    """The JAX package's free-flyer states (tests/test_contact_fused.py): a
    random unit quaternion, pos ± 0.1 m about z = 0.5, the joints about the
    robot's posture, vb ± 0.6, q̇ ± 0.5, τ ± 10; (quat, pos, q, vb, qd,
    tau), each (d, B), or batch first."""
    _, _, _, posture, spread = FF_ROBOTS[label]

    def uni(d, r):
        return (torch.rand((B, d), generator=gen, device="cuda",
                           dtype=m.dtype) * (2 * r) - r)
    quat = torch.randn((B, 4), generator=gen, device="cuda", dtype=m.dtype)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    pos = uni(3, 0.1) + torch.tensor([0.0, 0.0, 0.5], dtype=m.dtype,
                                     device="cuda")
    mean = torch.tensor(posture, dtype=m.dtype, device="cuda").repeat(
        m.n // len(posture))
    out = [quat, pos, mean + uni(m.n, spread), uni(6, 0.6), uni(m.n, 0.5),
           uni(m.n, 10.0)]
    return out if layout == "Bd" else [x.T.contiguous() for x in out]


def ff_geometry(label):
    """(links, offsets (k, 3), anchors (k, 3)) of a free flyer's stance."""
    _, links, off, _, _ = FF_ROBOTS[label]
    anchors = np.random.default_rng(SEED).uniform(-0.1, 0.1, (len(links), 3))
    return links, np.tile(off, (len(links), 1)), anchors


def ff_pairs(label):
    """The kernels of ff.cu as name → (LAUNCHES key, kernel, plain, whether
    it takes pos): ABA, the mass-matrix FD, the stance FD plain and with
    Baumgarte, anchors and a ridge."""
    links, off, anchors = ff_geometry(label)

    def stance(fn, **kw):
        return lambda m, *s: fn(m, *s, links, off, **kw)
    bg = dict(FF_BAUMGARTE, anchors=anchors)
    return {
        "fb_aba": ("fb_aba", cff.fb_aba_fused, cff.fb_aba_plain, False),
        "fb_fd": ("fb_fd", cff.fb_fd_fused, cff.fb_fd_plain, False),
        "stance_fd": ("stance_fd", stance(cff.stance_fd_fused),
                      stance(cff.stance_fd_plain), True),
        "stance_fd_baumgarte": ("stance_fd",
                                stance(cff.stance_fd_fused, **bg),
                                stance(cff.stance_fd_plain, **bg), True),
    }


def ff_args(s, with_pos):
    """(quat, [pos,] q, vb, qd, tau) from ff_states' six."""
    return tuple(s) if with_pos else (s[0], *s[2:])


@functools.lru_cache(maxsize=None)
def step_terrain(grid, dtype, device="cuda"):
    """A height grid of STEP_GRIDS (None: the flat ground), made once."""
    return (None if grid is None
            else ttr.bumpy_terrain(**STEP_GRIDS[grid], dtype=dtype,
                                   device=device))


@functools.lru_cache(maxsize=None)
def step_geoms(dtype, device="cuda"):
    """HyQ's ground geoms (STEP_GEOMS) in ``dtype`` on ``device``."""
    g = STEP_GEOMS
    return gt.make_geoms(g["links"], g["a"], g["b"], g["r"], dtype=dtype,
                         device=device)


def step_contacts(label, geoms):
    """The contact count of a step: the robot's feet, and HyQ's geoms'
    endpoint spheres with ``geoms``."""
    return (len(FF_ROBOTS[label][1])
            + (gt.n_ground_contacts(step_geoms(torch.float64, "cpu"))
               if geoms else 0))


def step_fns(label, grid, opts, dtype, device="cuda", geoms=False,
             cset=None, lset=None):
    """A ground step's kernel and its plain version, each f(m, quat, pos,
    q, vb, qd, tau, mu[, push]) → (quat⁺, pos⁺, q⁺, vb⁺, q̇⁺, p (3k_t, B)),
    batch last: the robot's feet (and with ``geoms`` HyQ's ground geoms,
    with ``cset`` a COLL_SETS collision set, with ``lset`` a LOOP_SETS
    closure set) on the flat ground or the grid ``grid``, and with
    ``opts`` a soft contact (STEP_SOFT) and restitution."""
    links, off, _ = ff_geometry(label)
    gg = step_geoms(dtype, device) if geoms else None
    cm = coll_model(cset, label, dtype, device)
    loops = None if lset is None else LOOP_SETS[lset]
    static = cff.ground_geoms_static(gg)
    cs = cff.collision_static(cm)
    ls = cff.loops_static(gt.parse_urdf(FF_ROBOTS[label][0]).n, loops)
    kw = dict(iters=STEP_ITERS, margin=STEP_MARGIN)
    if opts:
        erp, soft = tct.soft_contact_params(*STEP_SOFT, STEP_DT)
        kw.update(erp=float(erp), softness=float(soft),
                  restitution=STEP_RESTITUTION)
    terr = step_terrain(grid, dtype, device)

    def kern(m, *s):
        both = dict(push=s[7] if len(s) > 7 else None, ground_geoms=gg,
                    collision=cm, loops=loops, **kw)
        if terr is None:
            return cff.step_ground_fused(m, *s[:7], STEP_DT, links, off,
                                         **both)
        return cff.step_ground_terrain_fused(m, *s[:7], STEP_DT, links, off,
                                             terr, **both)

    def plain(m, *s):
        return cff.step_ground_plain(
            m, *s[:7], STEP_DT, links, off, push=s[7] if len(s) > 7 else None,
            terrain=terr, ground_static=static, collision_static=cs,
            loop_static=ls, **kw)
    return kern, plain


def step_inputs(m, B, gen, label, opts, geoms=False):
    """A step's μ (k_t, B), per environment and contact in [0.3, 1.0], and
    with ``opts`` a base push (6, B) of ± STEP_PUSH."""
    k = step_contacts(label, geoms)
    mu = torch.rand((k, B), generator=gen, device="cuda", dtype=m.dtype)
    out = [mu * 0.7 + 0.3]
    if opts:
        out.append(torch.rand((6, B), generator=gen, device="cuda",
                              dtype=m.dtype) * (2 * STEP_PUSH) - STEP_PUSH)
    return out


def step_feet(m, quat, pos, q, label, grid, geoms=False, cset=None):
    """The contacts of batch-last states in float64 — the feet, with
    ``cset`` a COLL_SETS collision set's contacts, and with ``geoms`` HyQ's
    geom spheres: their gaps (k_t, B), along the surface normal on the grid
    ``grid``, and the ground contacts' world points (the feet's and the
    geom spheres' (3, B); a sphere's centre)."""
    m64 = m.to(dtype=torch.float64)
    quat, pos, q = (x.double() for x in (quat, pos, q))
    links, off, _ = ff_geometry(label)
    static = cff.ground_geoms_static(step_geoms(torch.float64, "cpu")
                              if geoms else None)
    cs = cff.collision_static(coll_model(cset, label))
    support = cff._rows_support(m64, links, static, cs, None)
    X = blops.joint_transforms_bl(m64.arm, q, joints=support)
    R = cff._quat_rot_s(quat)
    fk = cff._fk_s(m64.arm, X, support)
    J, xs = cff._ff_contact_rows_s(m64, X, R, links, off, fk)
    terr = step_terrain(grid, m.dtype, q.device.type)
    if terr is not None:
        terr = ttr.placed(terr, q.device, torch.float64)[0]
    gaps, _ = cff._ground_rows(R, pos, J, xs, 0.0, STEP_MARGIN, terr)
    points = [pos + cff._mv3s(R, x) for x in xs]
    if cs is not None:
        gaps = gaps + cff._collision_rows_s(m64, X, R, pos, cs, fk)[1]
    if static:
        _, g_gaps, _ = cff._ground_geom_rows(m64, R, pos, *fk, static, 0.0,
                                             STEP_MARGIN, terr)
        gaps = gaps + g_gaps
        one = pos[0:1] * 0.0 + 1.0
        points += [pos + cff._mv3s(R, torch.cat([one * c for c in e])
                                   if l < 0 else
                                   fk[1][l] + cff._mv3s_c(fk[0][l], e))
                   for l, e, _ in static]
    return torch.cat(gaps), points


def step_switches(m, s, label, grid, geoms=False, cset=None):
    """(keep (B,), gaps (k_t, B)): ``keep`` marks the states none of whose
    contacts lies within STEP_SWITCH of a switch — its float64 gap of the
    margin, or (a ground contact on a grid) its position of a cell edge,
    in cells."""
    gaps, feet = step_feet(m, *s[:3], label, grid, geoms, cset)
    near = (gaps - STEP_MARGIN).abs().lt(STEP_SWITCH).any(0)
    terr = step_terrain(grid, m.dtype, s[0].device.type)
    if terr is not None:
        for p_w in feet:
            u, v, _, _ = ttr.cell_index(terr, p_w[0], p_w[1])
            near |= torch.minimum((u - u.round()).abs(),
                                  (v - v.round()).abs()) < STEP_SWITCH
    return ~near, gaps


@functools.lru_cache(maxsize=None)
def _coll_model(name, label, dtype, device):
    (links, a, b, r), obs, pairs = COLL_SETS[name]
    geoms = gt.make_geoms(links, a, b, r, dtype=dtype, device=device)
    return gt.make_collision_model(
        geoms, topology=gt.parse_urdf(FF_ROBOTS[label][0]).topology,
        pairs=pairs,
        obstacles=(None if obs is None else
                   gt.make_obstacles(obs[0], r=obs[1], dtype=dtype,
                                     device=device)))


def coll_model(name, label, dtype=torch.float64, device="cpu"):
    """The CollisionModel of a COLL_SETS set on ``label``'s tree (None for
    None), made once."""
    return None if name is None else _coll_model(name, label, dtype, device)


def rows_fns(case, dtype, device="cuda"):
    """A ROWS_CASES case's step kernel and plain version (step_fns) and
    the LAUNCHES key."""
    label, cset, geoms, lset, grid, opts = ROWS_CASES[case]
    return (*step_fns(label, grid, opts, dtype, device, geoms, cset, lset),
            "step_ground" if grid is None else "step_ground_terrain")


def rows_counts(case):
    """(feet, collision contacts, ground-geom contacts) of a case."""
    label, cset, geoms, _, _, _ = ROWS_CASES[case]
    cm = coll_model(cset, label)
    return (len(FF_ROBOTS[label][1]), 0 if cm is None else cm.n_contacts,
            step_contacts("hyq", True) - 4 if geoms else 0)


def rows_inputs(m, B, gen, case):
    """A case's μ (k_t, B), per environment and contact in [0.3, 1.0], and
    with its options a base push (6, B) of ± STEP_PUSH."""
    mu = torch.rand((sum(rows_counts(case)), B), generator=gen,
                    device="cuda", dtype=m.dtype)
    out = [mu * 0.7 + 0.3]
    if ROWS_CASES[case][5]:
        out.append(torch.rand((6, B), generator=gen, device="cuda",
                              dtype=m.dtype) * (2 * STEP_PUSH) - STEP_PUSH)
    return out


def rows_switches(m, s, case):
    """step_switches of a case's contacts."""
    label, cset, geoms, _, grid, _ = ROWS_CASES[case]
    return step_switches(m, s, label, grid, geoms, cset)


def loop_states(m, B, gen, device="cuda", layout="dB", closed=False):
    """bench_loops.py's four-bar states (:97-105): a random unit
    quaternion, pos ± 0.1 about z = 0.25, q ± 0.2, vb and q̇ ± 1, τ ± 1; with
    ``closed`` the joints on the parallelogram (θ, −θ, θ), whose closure
    holds exactly. → (quat, pos, q, vb, qd, tau), each (d, B), or batch
    first."""
    def uni(d, r):
        return (torch.rand((B, d), generator=gen, device=device,
                           dtype=m.dtype) * (2 * r) - r)
    quat = torch.randn((B, 4), generator=gen, device=device, dtype=m.dtype)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    pos = uni(3, 0.1) + torch.tensor([0.0, 0.0, 0.25], dtype=m.dtype,
                                     device=device)
    q = uni(m.n, 0.2)
    if closed:
        q = q[:, :1] * torch.tensor([1.0, -1.0, 1.0], dtype=m.dtype,
                                    device=device)
    out = [quat, pos, q, uni(6, 1.0), uni(m.n, 1.0), uni(m.n, 1.0)]
    return out if layout == "Bd" else [x.T.contiguous() for x in out]


def rows_states(m, B, gen, label, layout="dB"):
    """Phase 1's random states of a case's robot (the four-bar's near the
    ground, the others as ff_states)."""
    if label == "four_bar":
        return loop_states(m, B, gen, layout=layout)
    return ff_states(m, B, gen, label, layout)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare(got, ref):
    """(normwise relative error, worst per-state relative error, max abs
    error) of kernel outputs against plain outputs, batch last."""
    rel = st = ab = 0.0
    for k, p in zip(_as_tuple(got), _as_tuple(ref)):
        diff = (k.double() - p.double()).abs()
        pa = p.double().abs()
        ab = max(ab, float(diff.max()))
        rel = max(rel, float(diff.max() / pa.max().clamp(min=1.0)))
        d_state = diff.reshape(-1, diff.shape[-1]).amax(0)
        p_state = pa.reshape(-1, pa.shape[-1]).amax(0).clamp(min=1.0)
        st = max(st, float((d_state / p_state).max()))
    return rel, st, ab


def check_finite(name, outs):
    for o in _as_tuple(outs):
        if not bool(torch.isfinite(o).all()):
            raise RuntimeError(f"{name}: non-finite output")


def expect_launch(key, before, name):
    if _launch.LAUNCHES[key] != before + 1:
        raise RuntimeError(f"{name}: kernel not launched")


# ---------------------------------------------------------------- phase 0
def phase0_toolchain():
    log(f"card: {card()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc}: {ver[-1]}")
    try:
        import triton  # noqa: F401
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    log(f"ninja: {shutil.which('ninja')}")


_PTXAS_NAME = re.compile(
    r"(md_step_ground|md_rnea|md_aba|md_id_grad|md_fd_grad|md_fd|md_vaf"
    r"|md_minv|vaf_tile|fd_grad_tile"
    r"|md_grad_cols|fb_aba|fb_fd|stance_fd|step_ground|fd_grad|id_grad"
    r"|fd_dense|fd|minv_dense_tile|minv_dense|minv_af|minv_ud|minv_cols"
    r"|minv|rnea|aba|vaf|grad_cols_tile|grad_cols|hessian|t1|t2|t4|t5)"
    r"_kernelI([fd])"
    r"(?:L([bi])(\d+)E)?")
_TEMPLATE_ARG = {"rnea": "qdd", "minv_dense": "rhs", "vaf": "mode",
                 "vaf_tile": "mode",
                 "minv_dense_tile": "rhs",
                 "grad_cols": "finish", "hessian": "lam", "t5": "q",
                 "fd_grad": "dense",
                 "md_rnea": "qdd", "md_id_grad": "qdd", "md_vaf": "qdd",
                 "md_minv": "rhs", "md_grad_cols": "finish",
                 "step_ground": "terrain"}


def ptxas_report(log_text):
    """One line per kernel: registers, stack frame and spills (a step
    kernel's cumulative stack includes its row builder's, slot_rows)."""
    lines, name, frame = [], None, ""
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            m = _PTXAS_NAME.search(ln)
            if m:
                arg = ("" if m.group(4) is None else
                       f", {_TEMPLATE_ARG.get(m.group(1), 't')}="
                       f"{m.group(4)}")
                name = (f"{m.group(1)}<"
                        f"{'float' if m.group(2) == 'f' else 'double'}{arg}>")
            else:
                name = ln.split("'")[1]
        elif "stack frame" in ln and name:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"  {name}: {ln.split(':', 1)[1].strip()}; {frame}")
            name = None
    return lines


def _with_staged(m):
    """A multi-dof model's default units and the staged multi-dof unit."""
    units = _build._units(_build.topology_key(m))
    return tuple(dict.fromkeys(units + (_build.MD_STAGED_UNIT,)))


def step_builds():
    """The ground steps' libraries past the stance's, label → (model, contact
    links, collision and loop pairs): the md step of the ball ant with and
    without its torso sphere and of free HyQ, HyQ's free-flyer step with its
    ground geoms, and the step of each ROWS_CASES case (cases on the same
    links and pairs share a library)."""
    feet, _, _ = md_step_contacts("ball_ant", True)
    gl = cff.geom_links(cff.ground_geoms_static(step_geoms(torch.float64,
                                                           "cpu")))
    out = {
        "ball_ant (md step, torso)": (md_step_model("ball_ant"), feet + (0,),
                                      None),
        "ball_ant (md step, feet)": (md_step_model("ball_ant"), feet, None),
        "free_hyq (md step)": (md_step_model("free_hyq"),
                               md_step_contacts("free_hyq", False)[0], None),
        "hyq (free flyer, ground geoms)": (ff_model("hyq"),
                                           FF_ROBOTS["hyq"][1] + gl, None),
    }
    for case, (label, *_) in ROWS_CASES.items():
        out[f"{label} ({case})"] = (ff_model(label), *rows_key(case))
    return out


def rows_key(case):
    """A ROWS_CASES case's library: (contact links — the feet, then HyQ's
    geom spheres' —, (collision links, loop pairs))."""
    label, cset, geoms, lset, _, _ = ROWS_CASES[case]
    gl = cff.geom_links(cff.ground_geoms_static(step_geoms(torch.float64,
                                                           "cpu")))
    cs = cff.collision_static(coll_model(cset, label))
    ls = cff.loops_static(gt.parse_urdf(FF_ROBOTS[label][0]).n,
                          None if lset is None else LOOP_SETS[lset])
    return (FF_ROBOTS[label][1] + (gl if geoms else ()),
            (cff.collision_links(cs), () if ls is None else ls.pairs))


# nvcc processes running before the next topology's start, while the checks
# run beside them on one core
BUILD_SLOTS = max(1, (os.cpu_count() or 2) - 1)


def start_builds(models, staged=(), links=None, pairs=None, only=None):
    """Build every topology (one nvcc per source and topology) on threads
    beside the checks, in the order of ``models`` — the order the checks
    need them — each once fewer than BUILD_SLOTS nvcc processes run: the
    staged multi-dof unit too for the labels in ``staged``, only the units
    ``only[label]`` of those labels, a free flyer's stance and step library
    for the contact links ``links[label]`` and the collision and loop
    ``pairs[label]``. A wrapper that reaches a library in its build waits
    for it (``_build.library`` holds one lock a topology). Returns the
    function that waits for every build, logs them and raises if one
    failed."""
    t0 = time.perf_counter()
    links, pairs, only = links or {}, pairs or {}, only or {}
    units = {label: _with_staged(m) if label in staged else only.get(label)
             for label, m in models.items()}
    free = threading.Condition()
    busy = [0]      # nvcc processes running
    workers = []

    def build(label, m, k):
        try:
            _build.library(m, units[label], links.get(label),
                           pairs.get(label))
        except RuntimeError:
            pass    # raised again by finish
        finally:
            with free:
                busy[0] -= k
                free.notify()

    def dispatch():
        # a topology's units start together once fewer than BUILD_SLOTS
        # nvcc processes run
        for label, m in models.items():
            k = len(units[label] or _build._units(_build.topology_key(
                m, links.get(label), pairs.get(label))))
            with free:
                free.wait_for(lambda: busy[0] < BUILD_SLOTS)
                busy[0] += k
            worker = threading.Thread(target=build, args=(label, m, k))
            worker.start()
            workers.append(worker)

    dispatcher = threading.Thread(target=dispatch)
    dispatcher.start()

    def finish():
        dispatcher.join()
        for worker in workers:
            worker.join()
        log(f"builds of {len(models)} topologies (each started once fewer "
            f"than {BUILD_SLOTS} nvcc ran): {time.perf_counter() - t0:.1f} s "
            f"wall")
        for label, m in models.items():
            # raises if a build failed
            lib = _build.library(m, units[label], links.get(label),
                                 pairs.get(label))
            if hasattr(m, "I_base"):
                what = (f"free flyer, contact links {links[label]}"
                        if links.get(label) else "free flyer")
                if pairs.get(label) and any(pairs[label]):
                    what += (f", collision links {pairs[label][0]}, loops "
                             f"{pairs[label][1]}")
            elif hasattr(m, "nv") and links.get(label):
                what = (f"nq={m.nq}, nv={m.nv}, the ground step of contact "
                        f"links {links[label]}")
            elif hasattr(m, "nv"):
                built = "built" if _build.md_dense_grads(m.nv) else "not built"
                what = (f"nq={m.nq}, nv={m.nv}, single-thread gradient "
                        f"kernels {built}, K5md column block "
                        f"{_build.md_col_block(m.n, m.nv)}")
            else:
                what = (f"K5 column block {_build.default_col_block(m.n)}, "
                        f"T5 {_build.so_col_block(m.n)}")
            root = _build.BUILD_DIR.parents[1]
            for unit in lib.paths:
                log(f"build {label} (n={m.n}) {unit}: nvcc "
                    f"{lib.build_seconds[unit]:.1f} s -> "
                    f"{lib.paths[unit].relative_to(root)} ({what})")
                for line in ptxas_report(lib.logs[unit]):
                    log(line)

    return finish


# ---------------------------------------------------------------- phase 1
def state_errors(got, ref):
    """Each state's largest error of ``got`` against ``ref`` (B,), every
    output relative to its largest magnitude over the batch (at least 1),
    as ``compare`` scales it."""
    err = None
    for a, b in zip(_as_tuple(got), _as_tuple(ref)):
        d = ((a.double() - b.double()).abs().reshape(-1, a.shape[-1]).amax(0)
             / b.double().abs().max().clamp(min=1.0))
        err = d if err is None else torch.maximum(err, d)
    return err


def moved_inputs(args, ulp, draws, seed=SEED):
    """``draws`` copies of the batch-last inputs side by side in the batch,
    every value moved by a random ± ``ulp`` relative."""
    B = args[0].shape[-1]
    gen = torch.Generator(device=args[0].device)
    gen.manual_seed(seed)
    return [(x.repeat(*(1,) * (x.dim() - 1), draws)
             * (1 + (torch.rand(x.shape[:-1] + (draws * B,), generator=gen,
                                device=x.device, dtype=x.dtype) * 2 - 1)
                * ulp)) for x in args]


def draw_errors(outs, ref, draws):
    """state_errors of each of ``draws`` side-by-side copies of a batch
    against ``ref``: (draws, B)."""
    B = ref[0].shape[-1] if isinstance(ref, tuple) else ref.shape[-1]
    return torch.stack([state_errors(tuple(o[..., d * B:(d + 1) * B]
                                           for o in _as_tuple(outs)), ref)
                        for d in range(draws)])


def sensitivity(plain, m64, args64, ref, dtype, draws=SENS_DRAWS):
    """Each state's sensitivity (B,) for a check in ``dtype``: the largest
    move of the plain float64 version's outputs ``ref`` (state_errors) when
    every input moves by a random ± SENS_ULP[dtype] relative, over
    ``draws`` draws (in one call: the draws side by side in the batch)."""
    moved = moved_inputs(args64, SENS_ULP[dtype], draws)
    return draw_errors(plain(m64, *moved), ref, draws).amax(0)


def check_sensitive(got, ref, scale, sel, tol):
    """Hold each state of the mask ``sel`` on its own: its error against
    ``ref`` (state_errors) at most max(tol, SENS_C·scale) there. Returns
    (ok, the log's account, the max abs error there)."""
    if not bool(sel.any()):
        return True, "; no state is round-off-sensitive", 0.0
    err = state_errors(got, ref)[sel]
    ratio = float((err / (SENS_C * scale[sel]).clamp(min=tol)).max())
    _, _, ab = compare(tuple(o[..., sel] for o in _as_tuple(got)),
                       tuple(o[..., sel] for o in _as_tuple(ref)))
    return ratio <= 1.0, (
        f"; {int(sel.sum())} of {sel.numel()} states round-off-sensitive "
        f"(sensitivity up to {float(scale[sel].max()):.3e}), each held to "
        f"max(tol, {SENS_C:g}x its own): worst error {float(err.max()):.3e},"
        f" worst error/bound {ratio:.3f} {'ok' if ratio <= 1.0 else 'FAIL'}"
        ), ab


def _f32_tol(plain32, ref):
    """The float32 check's normwise tolerance on the states ``rest`` (a
    (B,) mask, or None for every state): 1e-5, or twice the plain float32
    version's own error there."""
    def tol(rest):
        def sub(x):
            return (_as_tuple(x) if rest is None
                    else tuple(o[..., rest] for o in _as_tuple(x)))
        return max(REL_TOL[torch.float32],
                   F32_PLAIN_FACTOR * compare(sub(plain32), sub(ref))[0])
    return tol


def _split_sensitive(got, ref, sens, keep, tol, plain32=None):
    """One pass of a sensitive check: the states whose sensitivity ``sens``
    passes REL_TOL / SENS_MARGIN (and ``keep``) each on its own
    (check_sensitive; in float32 scaled by the larger of ``sens`` and the
    plain float32 version's error ``plain32`` there), the rest normwise at
    ``tol`` (a function of the rest: float32's depends on the plain float32
    version's error there). → (out mask, rest mask, tol, sensitive ok, note,
    their max abs error, the states past either check)."""
    dtype = ref[0].dtype if isinstance(ref, tuple) else ref.dtype
    out = sens > REL_TOL[torch.float32 if plain32 is not None
                         else dtype] / SENS_MARGIN
    if keep is not None:
        out = out & keep
    rest = ~out if keep is None else keep & ~out
    t = tol(rest)
    scale = sens if plain32 is None else torch.maximum(
        sens, state_errors(plain32, ref))
    ok, note, ab = check_sensitive(got, ref, scale, out, t)
    err = state_errors(got, ref)
    rest_err = state_errors(tuple(o[..., rest] for o in _as_tuple(got)),
                            tuple(o[..., rest] for o in _as_tuple(ref)))
    past = torch.zeros_like(out)
    past[rest] = rest_err > t
    past |= out & (err > (SENS_C * scale).clamp(min=t))
    return out, rest, t, ok, note, ab, past


def check_against_plain(tag, got, plain, m, args, keep=None,
                        sensitive=False):
    """Hold a kernel's output to its plain version on the same inputs: in
    float64 directly; in float32 against the plain version run in float64
    on the same (upcast) inputs, beside the plain float32 version's own
    error against that reference — on the states ``keep`` (a (B,) mask)
    only, where it is given: a ground step's states whose float64 gap or
    cell position lies within rounding of a switch (step_exclusions). With
    ``sensitive``, the round-off-sensitive states are held each on its own
    (check_sensitive) and the rest normwise. Returns (max abs
    error, normwise relative error)."""
    t0 = time.perf_counter()
    sens_ok, note, s_ab = True, "", 0.0
    f64 = m.dtype == torch.float64
    if f64:
        ref = plain(m, *args)
        m64, args64, plain32 = m, args, None
    else:
        m64, args64 = m.to(dtype=torch.float64), [x.double() for x in args]
        ref = plain(m64, *args64)
        plain32 = plain(m, *args)

    tol_of = ((lambda rest: REL_TOL[m.dtype]) if f64
              else _f32_tol(plain32, ref))
    rest = keep
    if sensitive:
        sens = sensitivity(plain, m64, args64, ref, m.dtype)
        out, rest, tol, sens_ok, note, s_ab, _ = _split_sensitive(
            got, ref, sens, keep, tol_of, plain32)
    else:
        tol = tol_of(keep)
    extra = note
    if not f64:
        p_rel, p_st, _ = compare(*(tuple(o[..., rest] for o in _as_tuple(x))
                                   if rest is not None else x
                                   for x in (plain32, ref)))
        k_rel, k_st, _ = compare(*(tuple(o[..., rest] for o in _as_tuple(x))
                                   if rest is not None else x
                                   for x in (got, plain32)))
        del plain32
        extra = (f"; plain f32 vs f64 plain: rel {p_rel:.3e} (per-state "
                 f"{p_st:.3e}); kernel vs plain f32: rel {k_rel:.3e} "
                 f"(per-state {k_st:.3e})")
        if keep is not None:
            extra += (f"; {int((~keep).sum())} of {keep.numel()} states "
                      f"left out near a switch")
        extra += note
    if rest is not None:
        got, ref = (tuple(o[..., rest] for o in _as_tuple(x))
                    for x in (got, ref))
    rel, st, ab = compare(got, ref)
    ok = rel <= tol and sens_ok
    ab = max(ab, s_ab)
    log(f"{tag}: rel {rel:.3e} (per-state {st:.3e}, abs {ab:.3e}) tol "
        f"{tol:.1e}{' (the other states)' if note else ''} "
        f"{'ok' if ok else 'FAIL'}{extra} "
        f"[{time.perf_counter() - t0:.1f} s]")
    if not ok:
        raise RuntimeError(f"{tag}: kernel disagrees with its plain version")
    return ab, rel


def run_pair(tag, key, kern, plain, m, args, keep=None, sensitive=False):
    """Launch a kernel once, check that it launched and is finite, and
    hold it to its plain version; returns (max abs error, relative)."""
    before = _launch.LAUNCHES[key]
    got = kern(m, *args)
    torch.cuda.synchronize()
    expect_launch(key, before, tag)
    check_finite(tag, got)
    return check_against_plain(tag, got, plain, m, args, keep, sensitive)


# phase 1's second-order checks left out in float64 (the 750 s budget):
# the Hessians on the branched arm (held in float64 on iiwa-14, in float32
# on both) and the tangent stages at Atlas (held in float64 on the branched
# arm at FORCED_CB, in float32 at Atlas)
SO_F32_ONLY = {"branched_arm": "hessians", "atlas": "stages"}
# and the steps left out in float64 (their inputs still drawn, so the later
# states do not move): HyQ with its ground geoms, flat and on the grid, and
# HyQ's collision cases (the feet-only steps, the chain's pair and the
# four-bar hold each step's rows in float64)
STEP_F32_ONLY = ("hyq_geoms", "hyq_collision", "hyq_collision_geoms",
                 "hyq_collision_options")


def phase1_second_order(label, m, q, qd, u, gen):
    """The single-thread Hessian kernels (iiwa-14, the branched arm) and the
    staged λᵀ·H's tangent stages (Atlas, and the branched arm at a forced
    ragged column block) against their plain versions (float64 but where
    SO_F32_ONLY leaves them out)."""
    lam = uniform_lam(m.n, q.shape[-1], m.dtype, gen)
    s = (q, qd, u, lam)
    tag = f"phase1 {label} {str(m.dtype)[6:]} B={q.shape[-1]}"
    skip = SO_F32_ONLY.get(label) if m.dtype == torch.float64 else None
    if label != "atlas" and skip != "hessians":
        for name, (key, kern, plain, k) in HESS_PAIRS.items():
            run_pair(f"{tag} {name}", key, kern, plain, m, s[:k])
    if label != "iiwa14" and skip != "stages":
        cb = FORCED_CB if label == "branched_arm" else None
        up, pairs = so_stage_pairs(cb)
        x = up(m, *s)
        for name, (key, kern, plain, inputs) in pairs.items():
            run_pair(f"{tag} staged {name}{'' if cb is None else f' cb={cb}'}",
                     key, kern, plain, m, inputs(s, x))


def phase1_kernels_vs_plain(gen):
    for label in ROBOTS:
        for dtype in (torch.float64, torch.float32):
            m = gt.load_robot(ROBOTS[label], dtype=dtype, device="cuda")
            B = PHASE1_B
            q, qd, u = uniform_states(m.n, B, dtype, gen)
            # past MAX_KERNEL_JOINTS, ∇FD, ∂ID and M⁻¹ are the staged
            # kernels checked below; RNEA and ABA run on one thread
            pairs = {k: v for k, v in PAIRS.items()
                     if _build.dense_grads(m.n)
                     or k in ("inverse_dynamics", "bias_force")}
            pairs["aba"] = ABA
            if _build.dense_grads(m.n):
                pairs.update(VARIANT_PAIRS)
            for name, (key, kern, plain, k) in pairs.items():
                args = (q, qd, u)[:k]
                before = _launch.LAUNCHES[key]
                got = kern(m, *args)
                torch.cuda.synchronize()
                expect_launch(key, before, name)
                check_finite(name, got)
                check_against_plain(
                    f"phase1 {label} {str(dtype)[6:]} B={B} {name}",
                    got, plain, m, args)
            phase1_second_order(label, m, q, qd, u, gen)
            if label == "iiwa14":
                continue
            cb = FORCED_CB if label == "branched_arm" else None
            up, spairs = staged_pairs(cb)
            x = up(m, q, qd, u)
            for name, (key, kern, plain, inputs) in spairs.items():
                args = inputs((q, qd, u), x)
                before = _launch.LAUNCHES[key]
                got = kern(m, *args)
                torch.cuda.synchronize()
                expect_launch(key, before, name)
                check_finite(name, got)
                check_against_plain(
                    f"phase1 {label} {str(dtype)[6:]} B={B} staged "
                    f"{name}{'' if cb is None else f' cb={cb}'}",
                    got, plain, m, args)
            x = phase1_variants(label, m, q, qd, u)
            phase1_tiles(label, m, q, qd, u, TILE_EXTRA[label], x)
    # HyQ's states come from a generator of their own: the later phases
    # draw the states they drew before these checks were added
    tile_gen = torch.Generator(device="cuda")
    tile_gen.manual_seed(TILE_SEED)
    for dtype in (torch.float64, torch.float32):
        m = gt.load_robot(ROUTE_ROBOTS[TILE_ROBOT], dtype=dtype,
                          device="cuda")
        phase1_tiles(TILE_ROBOT, m,
                     *uniform_states(m.n, PHASE1_B, dtype, tile_gen))
    # the recursion ∇FD tile on the prismatic chain (iiwa-14 and the
    # branched arm hold it above, as PAIRS' fd_grad)
    for dtype in (torch.float64, torch.float32):
        m = gt.load_robot(FD_TILE_ROBOTS["chain5p"], dtype=dtype,
                          device="cuda")
        phase1_fd_tile("chain5p", m,
                       *uniform_states(m.n, PHASE1_B, dtype, tile_gen))


def phase1_tiles(label, m, q, qd, u, names=None, x=None):
    """K5 and K2′ (the CTA tiles) against their plain versions in the modes
    ``names`` of tile_pairs (None: every mode), on the plain upstream
    stages ``x`` (variant_pairs' up; computed where not given)."""
    up, pairs = tile_pairs()
    x = up(m, q, qd, u) if x is None else x
    for name in names or pairs:
        key, kern, plain, inputs = pairs[name]
        run_pair(f"phase1 {label} {str(m.dtype)[6:]} B={q.shape[-1]} tile "
                 f"{name}", key, kern, plain, m, inputs((q, qd, u), x))


BF16_REL = 2e-2   # bf16 staging against full precision (test_blops.py:379)
FORCED_MINV_CB = 2  # K3 on the branched arm: blocks 2, 2, 2, 2, 1


def phase1_variants(label, m, q, qd, u):
    """The staged.cu variants against their plain versions on the same
    inputs (variant_pairs): on Atlas at the compiled widths, on the branched
    arm at FORCED_CB and K3 at its compiled width (one block) and at
    FORCED_MINV_CB. On the branched arm — the JAX test's setting, one
    branched robot — the bf16-reading K4 and K5 are also held to the plain
    versions on the full-precision stage tensors (BF16_REL); at Atlas, where
    bf16 round-off of M⁻¹ in the finish moves one stage's worst of 1000
    states by ≈ 2e-2 (the JAX record: 0.8–1.7e-2, BENCHLOG.md:155), phase
    V holds the whole pipeline's bf16-vs-full ∇FD to BF16_REL with JAX's
    tensor-wide metric. Returns the plain upstream stages (up's x)."""
    tag = f"phase1 {label} {str(m.dtype)[6:]} B={q.shape[-1]} variant"
    first = None
    widths = ([(FORCED_CB, None), (FORCED_CB, FORCED_MINV_CB)]
              if label == "branched_arm" else [(None, None)])
    for cb, mcb in widths:
        up, vpairs = variant_pairs(cb, mcb)
        x = up(m, q, qd, u)
        first = first or x
        names = list(vpairs) if mcb is None else ["minv_cols"]
        for name in names:
            key, kern, plain, inputs = vpairs[name]
            args = inputs((q, qd, u), x)
            where = "".join(f" {k}={w}" for k, w in
                            (("cb", cb), ("K3 cb", mcb)) if w is not None)
            run_pair(f"{tag} {name}{where}", key, kern, plain, m, args)
        if mcb is not None or label != "branched_arm":
            continue
        _, spairs = staged_pairs(cb)
        for name, full in (("af_bf16", "af"),
                           ("grad_cols_finish_bf16", "grad_cols_finish"),
                           ("grad_cols_bf16", "grad_cols")):
            got = vpairs[name][1](m, *vpairs[name][3]((q, qd, u), x))
            ref = spairs[full][2](m, *spairs[full][3]((q, qd, u), x))
            rel, _, _ = compare(got, ref)
            ok = rel <= BF16_REL
            log(f"{tag} {name} vs plain {full} at full precision: rel "
                f"{rel:.3e} tol {BF16_REL:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{tag} {name}: bf16 staging too far "
                                   f"from full precision")
    return first


def phase1_multidof(gen):
    """The five multi-dof kernels of md.cu (and the qdd=None variants)
    against their plain versions at B = 1000, float64 and float32, on the
    ball arm, free iiwa-14, the mixed chain and free HyQ, and on the ball
    arm with armature."""
    cases = [(label, None) for label in MD_CHECK] + [("ball_arm",
                                                      MD_ARMATURE)]
    for label, arm in cases:
        for dtype in (torch.float64, torch.float32):
            m = md_model(label, dtype, arm)
            s = md_states(m, PHASE1_B, gen)
            tag = (f"phase1 {label}{'' if arm is None else f' armature {arm}'}"
                   f" {str(dtype)[6:]} B={PHASE1_B}")
            for name, (key, kern, plain, k) in MD_PAIRS.items():
                run_pair(f"{tag} {name}", key, kern, plain, m, s[:k])


def phase1_md_staged(gen):
    """The staged multi-dof kernels against their plain versions at
    B = 1000, float64 and float32: on free Atlas at the built column width
    (with its CRBA FD), and forced on free iiwa-14 and the ball arm at
    widths that cut a free or ball joint. Returns free Atlas's float32
    max abs errors by kernel."""
    max_abs = {}
    for label, cb in MD_STAGED_CHECK.items():
        for dtype in (torch.float64, torch.float32):
            m = md_model(label, dtype)
            s = md_states(m, PHASE1_B, gen)
            tag = (f"phase1 {label} {str(dtype)[6:]} B={PHASE1_B} staged"
                   + ("" if cb is None else f" cb={cb}"))
            if label == "free_atlas":
                key, kern, plain, _ = MD_PAIRS["md_fd"]
                run_pair(f"phase1 {label} {str(dtype)[6:]} B={PHASE1_B} md_fd",
                         key, kern, plain, m, s)
            up, pairs = md_staged_pairs(cb)
            x = up(m, *s)
            for name, (key, kern, plain, inputs) in pairs.items():
                ab, _ = run_pair(f"{tag} {name}", key, kern, plain, m,
                                 inputs(s, x))
                if label == "free_atlas" and dtype == torch.float32:
                    max_abs[name] = ab
    return max_abs


def phase1_free_flyer(gen):
    """The kernels of ff.cu — ABA, the mass-matrix FD, the stance (plain,
    and with Baumgarte, anchors and a ridge) and the ground step (STEP_CASES:
    flat and on both grids, with and without a push, a soft contact and
    restitution, μ per environment and foot) — against their plain
    versions at B = 1000 on free-flyer HyQ, Atlas and the 3-link chain:
    float64 and float32 (the step's float32 away from a switch), and
    float64 with armature."""
    for label in FF_CHECK:
        for dtype, arm in ((torch.float64, None), (torch.float32, None),
                           (torch.float64, FF_ARMATURE)):
            m = ff_model(label, dtype, arm)
            s = ff_states(m, PHASE1_B, gen, label)
            tag = (f"phase1 free {label}"
                   f"{'' if arm is None else f' armature {arm}'} "
                   f"{str(dtype)[6:]} B={PHASE1_B}")
            for name, (key, kern, plain, wp) in ff_pairs(label).items():
                run_pair(f"{tag} {name}", key, kern, plain, m,
                         ff_args(s, wp))
            for name, (grid, opts) in STEP_CASES.items():
                kern, plain = step_fns(label, grid, opts, dtype)
                keep = (None if dtype == torch.float64
                        else step_switches(m, s, label, grid)[0])
                run_pair(f"{tag} {name}",
                         "step_ground" if grid is None
                         else "step_ground_terrain", kern, plain, m,
                         (*s, *step_inputs(m, PHASE1_B, gen, label, opts)),
                         keep)
            if label != "hyq" or arm is not None:
                continue
            # HyQ with its ground geoms (14 contacts), flat and on the grid
            for grid in (None, "121"):
                kern, plain = step_fns(label, grid, False, dtype, geoms=True)
                f64 = dtype == torch.float64
                if f64 and "hyq_geoms" in STEP_F32_ONLY:
                    step_inputs(m, PHASE1_B, gen, label, False, geoms=True)
                    continue
                run_pair(f"{tag} step_ground{'' if grid is None else '_terrain'}"
                         f"_geoms ({step_contacts(label, True)} contacts)",
                         "step_ground" if grid is None
                         else "step_ground_terrain", kern, plain, m,
                         (*s, *step_inputs(m, PHASE1_B, gen, label, False,
                                           geoms=True)),
                         None if f64 else step_switches(m, s, label, grid,
                                                        geoms=True)[0],
                         sensitive=True)


# ------------------------------------------------------ the multi-dof step
@functools.lru_cache(maxsize=None)
def ant_geometry():
    """The ball ant's MJCF document, its foot links and offsets (k, 3)."""
    src = zoo.ball_ant_mjcf()
    sites = gt.mjcf_sites(src)
    return (src, tuple(sites[f"foot{k}"].link for k in range(4)),
            np.stack([sites[f"foot{k}"].pos for k in range(4)]))


def md_step_model(label, dtype=torch.float32, device="cuda"):
    """The ball ant (from MJCF) or free HyQ as a multi-dof model."""
    desc = gt.parse_mjcf(ant_geometry()[0]) if label == "ball_ant" else (
        gt.parse_urdf(zoo.with_free_joint(FF_ROBOTS["hyq"][0])))
    return gt.multidof_model_from_description(desc, dtype=dtype,
                                              device=device)


def md_step_contacts(label, torso):
    """(feet links, offsets, ground geoms or None) of a multi-dof step: the
    ball ant's feet (and torso sphere), free HyQ's feet (links shifted by
    its free joint)."""
    if label == "ball_ant":
        _, feet, offs = ant_geometry()
    else:
        feet = tuple(l + 1 for l in FF_ROBOTS["hyq"][1])
        offs = np.tile(FF_ROBOTS["hyq"][2], (len(feet), 1))
    return feet, offs, torso


@functools.lru_cache(maxsize=None)
def md_torso(dtype, device="cuda"):
    t = MD_TORSO
    return gt.make_geoms(t["links"], t["a"], r=t["r"], dtype=dtype,
                         device=device)


def md_knee_limits(m):
    """(lo, hi) (nq,): the ball ant's knees in MD_KNEE_LIMITS, ±inf on the
    free and ball slots."""
    lo = torch.full((m.nq,), -float("inf"), dtype=torch.float64)
    hi = torch.full((m.nq,), float("inf"), dtype=torch.float64)
    for i, t in enumerate(m.joint_types):
        if t == "revolute":
            lo[m.q_slices[i][0]], hi[m.q_slices[i][0]] = MD_KNEE_LIMITS
    return lo, hi


def md_step_fns(label, torso, opts, dtype, device="cuda"):
    """The md step's kernel and its plain version, each f(m, q, qd, tau,
    mu) → (q⁺ (nq, B), v⁺ (nv, B), p (3k_t, B)), batch last; with ``opts``
    a soft contact, restitution and the knees' limits projected after the
    step (as the entry does)."""
    feet, offs, _ = md_step_contacts(label, torso)
    gg = md_torso(dtype, device) if torso else None
    static = cff.ground_geoms_static(gg)
    kw = dict(iters=STEP_ITERS, margin=STEP_MARGIN)
    if opts:
        erp, soft = tct.soft_contact_params(*STEP_SOFT, MD_STEP_DT)
        kw.update(erp=float(erp), softness=float(soft),
                  restitution=STEP_RESTITUTION)

    def limited(m, out):
        if not opts:
            return out
        lo, hi = md_knee_limits(m)
        q2, v2 = tmc.md_project_joint_limits(m, out[0].T, out[1].T, lo, hi)
        return q2.T, v2.T, out[2]

    def kern(m, *s):
        return limited(m, mdsf.md_step_ground_fused(
            m, *s, MD_STEP_DT, feet, offs, ground_geoms=gg, **kw))

    def plain(m, *s):
        return limited(m, mdsf.md_step_ground_plain(
            m, *s, MD_STEP_DT, feet, offs, ground_static=static, **kw))
    return kern, plain


def md_step_states(m, B, gen, device="cuda"):
    """bench_contact.py's md states (:277-285): neutral_q ⊕ a tangent step
    in U(±0.25), the base height raised by U(0, 0.15) (feet and torso in
    touch range), q̇ ± 0.4, τ ± 3 — (q, qd, tau), batch first."""
    def uni(d, r):
        return (torch.rand((B, d), generator=gen, device=device,
                           dtype=m.dtype) * (2 * r) - r)
    q = gt.md_tangent_apply(m, gt.neutral_q(m).expand(B, -1), uni(m.nv, 0.25))
    q[:, 6] += torch.rand(B, generator=gen, device=device,
                          dtype=m.dtype) * 0.15
    return q, uni(m.nv, 0.4), uni(m.nv, 3.0)


def md_step_gaps(m, q, label, torso):
    """Float64 gaps (k_t, B) of batch-last md states: the feet's, then the
    torso sphere's less its radius."""
    feet, offs, _ = md_step_contacts(label, torso)
    m64 = m.to(dtype=torch.float64)
    q = q.double()
    static = cff.ground_geoms_static(md_torso(torch.float64, q.device.type)
                              if torso else None)
    contacts = ([(l, [float(x) for x in offs[i]], 0.0)
                 for i, l in enumerate(feet)]
                + [(l, list(e), r) for l, e, r in static])
    Rs, ps = cff._fk_s(m64, tmdb.md_transforms_bl(m64, q),
                       cff._support(m64.topology, [c[0] for c in contacts]))
    return torch.cat([(ps[l] + cff._mv3s_c(Rs[l], e))[2:3] - r
                      for l, e, r in contacts])


def md_step_keep(m, q_bl, label, torso):
    """The states none of whose contacts' float64 gap lies within
    STEP_SWITCH of the margin."""
    gaps = md_step_gaps(m, q_bl, label, torso)
    return ~(gaps - STEP_MARGIN).abs().lt(STEP_SWITCH).any(0)


def md_step_mu(m, B, gen, label, torso):
    """μ (k_t, B): the feet's per environment in [0.3, 1.0], the torso
    sphere's STEP_MU_GROUND."""
    feet = md_step_contacts(label, torso)[0]
    mu = (torch.rand((1, B), generator=gen, device="cuda", dtype=m.dtype)
          * 0.7 + 0.3).expand(len(feet), B)
    if torso:
        mu = torch.cat([mu, torch.full((1, B), STEP_MU_GROUND,
                                       dtype=m.dtype, device="cuda")])
    return mu.contiguous()


def phase1_md_step(gen):
    """The md step kernel (md_step.cu) against its plain version at B =
    1000, float64 and float32, in MD_STEP_CASES: the ball ant with its
    torso sphere, with softness, restitution and the knees' projected
    limits, its feet only, and free HyQ's feet. The float32 checks leave
    out, and count, the states with a contact's float64 gap within
    STEP_SWITCH of the margin."""
    for name, (label, torso, opts) in MD_STEP_CASES.items():
        for dtype in (torch.float64, torch.float32):
            m = md_step_model(label, dtype)
            s = [x.T.contiguous() for x in md_step_states(m, PHASE1_B, gen)]
            mu = md_step_mu(m, PHASE1_B, gen, label, torso)
            kern, plain = md_step_fns(label, torso, opts, dtype)
            keep = (None if dtype == torch.float64
                    else md_step_keep(m, s[0], label, torso))
            run_pair(f"phase1 {label} {str(dtype)[6:]} B={PHASE1_B} {name}",
                     "md_step_ground", kern, plain, m, (*s, mu), keep)


def md_cross_check(gen):
    """Free HyQ's md step against its free-flyer step on the same float64
    states (ff_states: random attitudes, feet in and out of contact), μ
    0.7: v⁺ and the impulses agree to MD_CROSS_TOL — two formulations of
    one velocity step (tests/test_md_contact.py:49-88; the configurations
    differ at O(dt²))."""
    ffm = ff_model("hyq", torch.float64)
    mdm = md_step_model("free_hyq", torch.float64)
    quat, pos, q, vb, qd, tau = ff_states(ffm, MD_CROSS_STATES, gen, "hyq")
    links, off, _ = ff_geometry("hyq")
    B = MD_CROSS_STATES
    mu = torch.full((len(links), B), MD_STEP_MU, dtype=torch.float64,
                    device="cuda")
    ff = cff.step_ground_fused(ffm, quat, pos, q, vb, qd, tau, mu, STEP_DT,
                               links, off, iters=STEP_ITERS)
    feet, offs, _ = md_step_contacts("free_hyq", False)
    md = mdsf.md_step_ground_fused(
        mdm, torch.cat([quat, pos, q]), torch.cat([vb, qd]),
        torch.cat([torch.zeros_like(vb), tau]), mu, STEP_DT, feet, offs,
        iters=STEP_ITERS)
    torch.cuda.synchronize()
    rel, st, ab = compare((md[1], md[2]), (torch.cat([ff[3], ff[4]]), ff[5]))
    active = float((ff[5][2::3] > 0).double().mean())
    ok = rel <= MD_CROSS_TOL
    log(f"phase1 md vs free-flyer step, free HyQ (f64, {B} states, "
        f"{active:.1%} of feet pushed): v⁺ and impulses rel {rel:.3e} "
        f"(per-state {st:.3e}, abs {ab:.3e}) tol {MD_CROSS_TOL:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the md step and the free-flyer step disagree")



# ---------------------------------------------------------------- phase 2
def parity_head(desc, J, q, qd, u, label):
    """bench.py's protocol: per state max|J − J_golden| / max(1,
    max|J_golden|) against the float64 golden model."""
    gold = gt.GoldenDynamics(desc)
    head = J[:PARITY_STATES].double().cpu().numpy()
    hq, hqd, hu = (x[:PARITY_STATES].double().cpu().numpy()
                   for x in (q, qd, u))
    errs = np.empty(PARITY_STATES)
    for k in range(PARITY_STATES):
        ref = gold.fd_grad(hq[k], hqd[k], hu[k])
        errs[k] = np.abs(head[k] - ref).max() / max(1.0, np.abs(ref).max())
    out = {"max": float(errs.max()), "p99": float(np.quantile(errs, 0.99)),
           "median": float(np.median(errs)), "states": PARITY_STATES}
    log(f"{label} f32-vs-golden relative parity ({PARITY_STATES} states): "
        f"max={out['max']:.3e} p99={out['p99']:.3e} "
        f"median={out['median']:.3e}")
    return out


def api_vs_plain(tag, outs, plains, m, states):
    """Each API output (batch first) against its plain version (batch
    last) on the first COMPARE_STATES states."""
    s = COMPARE_STATES
    cols = [x[:s].T.contiguous() for x in states]
    max_abs = {}
    for name, out in outs.items():
        plain, k = plains[name]
        max_abs[name], _ = check_against_plain(
            f"{tag} {name} API vs plain ({s} states)",
            out[:s].movedim(0, -1), plain, m, cols[:k])
    return max_abs


def _cat_sides(f):
    return lambda *a, **kw: torch.cat(f(*a, **kw), 1)  # [∂/∂q | ∂/∂q̇]


def phase2_main_path(gen):
    desc = gt.parse_urdf(ROBOTS["iiwa14"])
    m = gt.robot_model_from_description(desc, dtype=torch.float32,
                                        device="cuda")
    n = m.n
    q, qd, u = uniform_states(n, MAIN_B, torch.float32, gen, layout="Bn")
    _launch.reset_launches()
    t0 = time.perf_counter()
    J = gt.forward_dynamics_gradient(m, q, qd, u)
    c = gt.inverse_dynamics(m, q, qd, u)
    bias = gt.bias_force(m, q, qd)
    Minv = gt.direct_minv(m, q)
    G = gt.inverse_dynamics_gradient(m, q, qd, u)
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    log(f"phase2 main path B={MAIN_B} (five API calls, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}")
    for name in ("fd_grad", "id_grad", "minv", "inverse_dynamics"):
        if launches[name] < 1:
            raise RuntimeError(f"main path never launched {name}")
    if J.device.type != "cuda" or tuple(J.shape) != (MAIN_B, n, 2 * n):
        raise RuntimeError(f"∇FD output {J.device} {tuple(J.shape)}")
    outs = {"fd_grad": J, "inverse_dynamics": c, "bias_force": bias,
            "minv": Minv, "id_grad": G}
    for name, out in outs.items():
        check_finite(name, out)
    parity = parity_head(desc, J, q, qd, u, "phase2")
    if parity["max"] > PARITY_MAX:
        raise RuntimeError(f"∇FD f32 parity head above {PARITY_MAX:.0e}")
    plains = {name: (_cat_sides(p) if name in ("fd_grad", "id_grad") else p,
                     k) for name, (_, _, p, k) in PAIRS.items()}
    max_abs = api_vs_plain("phase2", outs, plains, m, (q, qd, u))

    # path B: forward_dynamics (ABA) on iiwa-14
    _launch.reset_launches()
    qdd = gt.forward_dynamics(m, q, qd, u)
    torch.cuda.synchronize()
    b_launches = dict(_launch.LAUNCHES)
    log(f"phase2 path B forward_dynamics B={MAIN_B}: launches {b_launches}")
    if b_launches["aba"] < 1:
        raise RuntimeError("path B never launched aba")
    check_finite("forward_dynamics", qdd)
    max_abs.update(api_vs_plain("phase2 path B", {"aba": qdd},
                                {"aba": (ABA[2], 3)}, m, (q, qd, u)))
    launches["aba"] = b_launches["aba"]
    return m, launches, max_abs, parity


# ---------------------------------------------------------------- phase A
def phaseA_atlas(gen):
    desc = gt.parse_urdf(ROBOTS["atlas"])
    m = gt.robot_model_from_description(desc, dtype=torch.float32,
                                        device="cuda")
    n = m.n
    q, qd, u = uniform_states(n, MAIN_B, torch.float32, gen, layout="Bn")
    _launch.reset_launches()
    t0 = time.perf_counter()
    outs = {
        "fd_grad": gt.forward_dynamics_gradient(m, q, qd, u),
        "id_grad": gt.inverse_dynamics_gradient(m, q, qd, u),
        "minv": gt.direct_minv(m, q),
        "inverse_dynamics": gt.inverse_dynamics(m, q, qd, u),
        "bias_force": gt.bias_force(m, q, qd),
        "aba": gt.forward_dynamics(m, q, qd, u),
    }
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    log(f"phaseA Atlas (n={n}) path B={MAIN_B} (six API calls, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    for name in ("bias_and_v", "minv_dense", "af", "grad_cols_finish", "vaf",
                 "grad_cols", "aba", "inverse_dynamics"):
        if launches[name] < 1:
            raise RuntimeError(f"Atlas path never launched {name}")
    for name in ("fd_grad", "id_grad", "minv"):
        if launches[name] != 0:
            raise RuntimeError(f"Atlas path launched the single-thread "
                               f"{name} kernel")
    J = outs["fd_grad"]
    if J.device.type != "cuda" or tuple(J.shape) != (MAIN_B, n, 2 * n):
        raise RuntimeError(f"Atlas ∇FD output {J.device} {tuple(J.shape)}")
    for name, out in outs.items():
        check_finite(name, out)

    # the 256-state head against the golden model, beside the plain f32
    # version's head on the same states
    parity = parity_head(desc, J, q, qd, u, "phaseA kernel")
    cols = [x[:PARITY_STATES].T.contiguous() for x in (q, qd, u)]
    Jp = torch.cat(staged.fd_grad_plain(m, *cols), 1).movedim(-1, 0)
    plain_parity = parity_head(desc, Jp, q, qd, u, "phaseA plain")
    bound = ATLAS_HEAD_FACTOR * plain_parity["max"]
    log(f"phaseA head: kernel max {parity['max']:.3e} vs bound "
        f"{bound:.3e} (= {ATLAS_HEAD_FACTOR} × plain f32 max) "
        f"{'ok' if parity['max'] <= bound else 'FAIL'}")
    if parity["max"] > bound:
        raise RuntimeError("Atlas ∇FD f32 head above twice the plain one")

    plains = {
        "fd_grad": (_cat_sides(staged.fd_grad_plain), 3),
        "id_grad": (_cat_sides(staged.id_grad_plain), 3),
        "minv": (lambda mm, qq: staged.minv_qdd_dense_plain(mm, qq)[0], 1),
        "inverse_dynamics": (fused.inverse_dynamics_plain, 3),
        "bias_force": (_bias_plain, 2),
        "aba": (fused.forward_dynamics_aba_plain, 3),
    }
    max_abs = {f"{k}[atlas]": v for k, v in api_vs_plain(
        "phaseA", outs, plains, m, (q, qd, u)).items()}
    # each stage kernel on the head states, against its plain version
    s = [x[:COMPARE_STATES].T.contiguous() for x in (q, qd, u)]
    up, spairs = staged_pairs()
    x = up(m, *s)
    for name, (key, kern, plain, inputs) in spairs.items():
        args = inputs(s, x)
        max_abs[name], _ = check_against_plain(
            f"phaseA stage {name} ({COMPARE_STATES} states)",
            kern(m, *args), plain, m, args)
    return m, (q, qd, u), launches, max_abs, parity, plain_parity


# ---------------------------------------------------------------- phase H
def symmetry(H):
    """max over states of max|H − Hᵀ| / max(1, max|H|), the last two
    structure axes transposed; H is batch first."""
    d = (H - H.transpose(-1, -2)).abs().reshape(H.shape[0], -1).amax(1)
    s = H.abs().reshape(H.shape[0], -1).amax(1).clamp(min=1.0)
    return float((d / s).max())


def check_symmetry(tag, H):
    sym = symmetry(H)
    log(f"{tag} symmetry max|H − Hᵀ|/max(1,|H|) {sym:.3e} (bound "
        f"{SYM_MAX:.0e}) {'ok' if sym <= SYM_MAX else 'FAIL'}")
    if sym > SYM_MAX:
        raise RuntimeError(f"{tag}: Hessian not symmetric")


def head_vs_plain(tag, out, plain, m, states, k=HEAD_STATES):
    """An API output's first k states (batch first) against its plain
    version on the same states (batch last)."""
    cols = [x[:k].T.contiguous() for x in states]
    ab, _ = check_against_plain(f"{tag} ({k} states)", out[:k].movedim(0, -1),
                                plain, m, cols)
    return ab


def vp_route(n):
    """(the λᵀ·H route's launch keys, its plain version) for n joints."""
    if _build.dense_hessian_vp(n):
        return ("hessian_vp",), so_fused.fd_hessian_vp_plain
    return ("t1", "t2", "t4", "t5"), so_staged.fd_hessian_vp_staged_plain


def phaseH_second_order(gen, mA):
    """Second order at B = 2¹⁶, float32, through the public API: iiwa-14's
    λᵀ·H (on its route), H and [∂q̈/∂q | ∂q̈/∂q̇ | M⁻¹] on the single-thread
    kernels; the λᵀ·H of SMALL_SO_ROBOT on the single-thread kernel; Atlas's
    λᵀ·H through the staged pipeline."""
    m = gt.load_robot(ROBOTS["iiwa14"], dtype=torch.float32, device="cuda")
    n = m.n
    vp_keys, vp_plain = vp_route(n)
    q, qd, u = uniform_states(n, HESS_B, torch.float32, gen, layout="Bn")
    lam = uniform_lam(n, HESS_B, torch.float32, gen, layout="Bn")
    torch.cuda.reset_peak_memory_stats()
    _launch.reset_launches()
    t0 = time.perf_counter()
    Hv = gt.forward_dynamics_hessian_vp(m, q, qd, u, lam)
    H = gt.forward_dynamics_hessian(m, q, qd, u)
    J = gt.forward_dynamics_gradient_full(m, q, qd, u)
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    log(f"phaseH iiwa14 B={HESS_B} (three API calls, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    for key in ("hessian", "fd_grad", "minv") + vp_keys:
        if launches[key] < 1:
            raise RuntimeError(f"iiwa second-order path never launched {key}")
    for key in {"hessian_vp", "t1", "t2", "t4", "t5"} - set(vp_keys):
        if launches[key] != 0:
            raise RuntimeError(f"iiwa second-order path launched {key}")
    shapes = {"hessian_vp": (Hv, (HESS_B, 3 * n, 3 * n)),
              "hessian": (H, (HESS_B, n, 3 * n, 3 * n)),
              "gradient_full": (J, (HESS_B, n, 3 * n))}
    for name, (out, shape) in shapes.items():
        if out.device.type != "cuda" or tuple(out.shape) != shape:
            raise RuntimeError(f"{name}: {out.device} {tuple(out.shape)}")
        check_finite(name, out)
    check_symmetry("phaseH iiwa14 λᵀ·H", Hv)
    check_symmetry("phaseH iiwa14 H", H)
    max_abs = {
        "hessian_vp[iiwa14]": head_vs_plain(
            "phaseH iiwa14 λᵀ·H API vs plain", Hv, vp_plain, m,
            (q, qd, u, lam)),
        "hessian": head_vs_plain("phaseH iiwa14 H API vs plain", H,
                                 so_fused.fd_hessian_plain, m, (q, qd, u)),
        "gradient_full": head_vs_plain(
            "phaseH iiwa14 gradient_full API vs plain", J, tso.fd_grad_full_bl,
            m, (q, qd, u)),
    }
    del H, Hv, J

    # λᵀ·H on the single-thread kernel
    m = gt.load_robot(HESS_ROUTE_ROBOTS[SMALL_SO_ROBOT], dtype=torch.float32,
                      device="cuda")
    if not _build.dense_hessian_vp(m.n):
        raise RuntimeError(f"{SMALL_SO_ROBOT} (n={m.n}) routes λᵀ·H to the "
                           f"staged pipeline")
    s = uniform_states(m.n, HESS_B, torch.float32, gen, layout="Bn")
    s.append(uniform_lam(m.n, HESS_B, torch.float32, gen, layout="Bn"))
    _launch.reset_launches()
    Hv = gt.forward_dynamics_hessian_vp(m, *s)
    torch.cuda.synchronize()
    s_launches = dict(_launch.LAUNCHES)
    log(f"phaseH {SMALL_SO_ROBOT} (n={m.n}) λᵀ·H B={HESS_B}: launches "
        f"{s_launches}")
    if s_launches["hessian_vp"] < 1:
        raise RuntimeError(f"{SMALL_SO_ROBOT} λᵀ·H never launched hessian_vp")
    if tuple(Hv.shape) != (HESS_B, 3 * m.n, 3 * m.n):
        raise RuntimeError(f"{SMALL_SO_ROBOT} λᵀ·H: {tuple(Hv.shape)}")
    check_finite("λᵀ·H", Hv)
    check_symmetry(f"phaseH {SMALL_SO_ROBOT} λᵀ·H", Hv)
    max_abs["hessian_vp"] = head_vs_plain(
        f"phaseH {SMALL_SO_ROBOT} λᵀ·H API vs plain", Hv,
        so_fused.fd_hessian_vp_plain, m, s)
    del Hv, s

    # Atlas: λᵀ·H through the staged pipeline
    n = mA.n
    sA = uniform_states(n, HESS_B, torch.float32, gen, layout="Bn")
    sA.append(uniform_lam(n, HESS_B, torch.float32, gen, layout="Bn"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch.reset_launches()
    t0 = time.perf_counter()
    HA = gt.forward_dynamics_hessian_vp(mA, *sA)
    torch.cuda.synchronize()
    a_launches = dict(_launch.LAUNCHES)
    log(f"phaseH Atlas (n={n}) λᵀ·H B={HESS_B} (one API call, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {a_launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    expect = {"bias_and_v": 1, "minv_dense": 1, "af": 1, "grad_cols": 1,
              "t1": 2, "t2": 1, "t4": 2, "t5": 3, "hessian_vp": 0}
    for key, count in expect.items():
        if a_launches[key] != count:
            raise RuntimeError(f"Atlas λᵀ·H launched {key} "
                               f"{a_launches[key]} times, not {count}")
    if HA.device.type != "cuda" or tuple(HA.shape) != (HESS_B, 3 * n, 3 * n):
        raise RuntimeError(f"Atlas λᵀ·H: {HA.device} {tuple(HA.shape)}")
    check_finite("Atlas λᵀ·H", HA)
    zeros = (float(HA[:, n:2 * n, 2 * n:].abs().max()),
             float(HA[:, 2 * n:, n:].abs().max()))
    log(f"phaseH Atlas λᵀ·H max|(q̇,u)| {zeros[0]} max|(u,q̇ u)| {zeros[1]} "
        f"(exact zeros) {'ok' if zeros == (0.0, 0.0) else 'FAIL'}")
    if zeros != (0.0, 0.0):
        raise RuntimeError("Atlas λᵀ·H: the (q̇, u) or (u, u) block is not 0")
    check_symmetry("phaseH Atlas λᵀ·H", HA)
    max_abs["hessian_vp[atlas]"] = head_vs_plain(
        "phaseH Atlas λᵀ·H API vs the plain staged pipeline", HA,
        so_staged.fd_hessian_vp_staged_plain, mA, sA, ATLAS_SO_HEAD)
    del HA
    # each tangent stage on the head states, against its plain version
    s = [x[:ATLAS_SO_HEAD].T.contiguous() for x in sA]
    up, pairs = so_stage_pairs()
    x = up(mA, *s)
    for name, (key, kern, plain, inputs) in pairs.items():
        max_abs[name], _ = run_pair(
            f"phaseH Atlas stage {name} ({ATLAS_SO_HEAD} states)", key, kern,
            plain, mA, inputs(s, x))
    return ({"iiwa14H": launches, "smallH": s_launches,
             "atlasH": a_launches}, max_abs, sA)


# ---------------------------------------------------------------- phase M
def md_solve_check(tag, m64, s64, fd_grad):
    """∂q̈/∂u·(u − c) against the ABA kernel's q̈, c from the ID kernel with
    qdd=None: M⁻¹ from the ∇FD route's factor against ABA's recursion,
    neither through the ∂ID recursion."""
    q, qd, u = s64
    Du = fd_grad(m64, q, qd, u)[2]
    c = mdf.md_id_fused(m64, q, qd)
    qdd = mdf.md_aba_fused(m64, q, qd, u)
    got = torch.einsum("ijb,jb->ib", Du, u - c)
    err = float(((got - qdd).abs().amax(0)
                 / qdd.abs().amax(0).clamp(min=1.0)).max())
    log(f"{tag} ∂q̈/∂u·(u − c) vs ABA q̈ (f64, {q.shape[-1]} states): rel "
        f"{err:.3e} (bound {MD_SOLVE_TOL:.0e}) "
        f"{'ok' if err <= MD_SOLVE_TOL else 'FAIL'}")
    if err > MD_SOLVE_TOL:
        raise RuntimeError(f"{tag}: ∂q̈/∂u·(u − c) disagrees with ABA")


def md_fd_check(tag, m64, s64, fd_grad):
    """∂q̈/∂δq and ∂q̈/∂q̇ of the ∇FD route against central differences of
    the ABA kernel along md_tangent_apply (float64, every direction of every
    state in one ABA launch a side)."""
    q, qd, u = s64
    nv, B = m64.nv, q.shape[-1]
    Dq, Dqd, _ = fd_grad(m64, q, qd, u)
    h = MD_FD_STEP
    step = torch.eye(nv, dtype=q.dtype, device=q.device) * h  # (nv dirs, nv)
    rep = lambda x: x.T[None].expand(nv, B, x.shape[0])        # (nv, B, k)
    dirs = step[:, None, :].expand(nv, B, nv)
    worst = 0.0
    for side, D in (("q", Dq), ("qd", Dqd)):
        outs = []
        for sign in (1.0, -1.0):
            qq, qqd = rep(q), rep(qd)
            if side == "q":
                qq = gt.md_tangent_apply(m64, qq, sign * dirs)
            else:
                qqd = qqd + sign * dirs
            flat = [x.reshape(nv * B, -1).T.contiguous()
                    for x in (qq, qqd, rep(u))]
            outs.append(mdf.md_aba_fused(m64, *flat).reshape(nv, nv, B))
        fd = (outs[0] - outs[1]) / (2 * h)          # (row, direction, B)
        err = float(((D - fd).abs().amax((0, 1))
                     / D.abs().amax((0, 1)).clamp(min=1.0)).max())
        worst = max(worst, err)
        log(f"{tag} ∂q̈/∂{'δq' if side == 'q' else 'q̇'} vs central "
            f"differences of ABA (f64, h {h:.0e}, {B} states): rel {err:.3e} "
            f"(bound {MD_FD_TOL:.0e}) {'ok' if err <= MD_FD_TOL else 'FAIL'}")
    if worst > MD_FD_TOL:
        raise RuntimeError(f"{tag}: ∇FD disagrees with central differences")


def md_route_check(tag, m64, s64):
    """The staged ∇FD and ∂ID kernels against the single-thread kernels on
    the same float64 states (both built here whatever the route limit)."""
    pairs = (("∇FD", mds.md_fd_grad_staged, mdf.md_fd_grad_fused),
             ("∂ID", mds.md_id_grad_staged, mdf.md_id_grad_fused))
    for fam, staged_fn, single in pairs:
        rel, st, ab = compare(staged_fn(m64, *s64), single(m64, *s64))
        ok = rel <= MD_ROUTE_TOL
        log(f"{tag} staged {fam} vs the single-thread kernel (f64, "
            f"{s64[0].shape[-1]} states): rel {rel:.3e} (per-state "
            f"{st:.3e}, abs {ab:.3e}) bound {MD_ROUTE_TOL:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{tag}: the staged {fam} disagrees with the "
                               f"single-thread kernel")


def md_crba_check(tag, m64, s64):
    """The CRBA FD kernel's q̈ against the ABA kernel's (float64)."""
    q, qd, u = s64
    got, ref = mdf.md_fd_fused(m64, q, qd, u), mdf.md_aba_fused(m64, q, qd, u)
    err = float(((got - ref).abs().amax(0)
                 / ref.abs().amax(0).clamp(min=1.0)).max())
    log(f"{tag} impl='crba' q̈ vs ABA q̈ (f64, {q.shape[-1]} states): rel "
        f"{err:.3e} (bound {MD_SOLVE_TOL:.0e}) "
        f"{'ok' if err <= MD_SOLVE_TOL else 'FAIL'}")
    if err > MD_SOLVE_TOL:
        raise RuntimeError(f"{tag}: the CRBA FD disagrees with ABA")


def phaseM_multidof(gen):
    """The multi-dof entry points at B = 2¹⁸, float32: free Atlas's ∇FD and
    ∂ID (the staged pipeline: the main path of the staged slice), its CRBA
    FD, ID and ABA; free iiwa-14's ∇FD, free HyQ's ∇FD and ∂ID, all four on
    the ball arm (the single-thread kernels). Each call runs with the
    counts set to 0 just before it and read just after, and must make
    exactly its route's launches (md_route) and nothing else; a 256-state
    head of each output is held to its plain version; on the ∇FD robots,
    checks that do not go through the ∂ID recursion, and at free Atlas the
    staged kernels against the single-thread ones, in float64 on a head of
    states."""
    launches, max_abs, states, models = {}, {}, {}, {}
    for label, fams in MD_PATHS.items():
        m = md_model(label)
        s = md_states(m, MAIN_B, gen, layout="Bn")
        models[label], states[label] = m, s
        for fam in fams:
            fn, k = MD_API[fam]
            expect, plain, _ = md_route(m, fam)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _launch.reset_launches()
            t0 = time.perf_counter()
            out = fn(m, *s[:k])
            torch.cuda.synchronize()
            got = dict(_launch.LAUNCHES)
            made = {k_: v for k_, v in got.items() if v}
            tag = f"phaseM {label} (n={m.n}, nq={m.nq}, nv={m.nv}) {fam}"
            log(f"{tag} B={MAIN_B} (first call): "
                f"{time.perf_counter() - t0:.3f} s; launches {made}; peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
            if made != expect:
                raise RuntimeError(f"{tag}: launched {made}, not {expect}")
            launches[f"{label}:{fam}"] = got
            shape = ((MAIN_B, m.nv) if fam in ("id", "aba", "crba")
                     else (MAIN_B, m.nv, m.nv))
            for o in _as_tuple(out):
                if o.device.type != "cuda" or tuple(o.shape) != shape:
                    raise RuntimeError(f"{tag}: {o.device} {tuple(o.shape)}")
            check_finite(tag, out)
            cols = [x[:PARITY_STATES].T.contiguous() for x in s[:k]]
            got_head = tuple(o[:PARITY_STATES].movedim(0, -1)
                             for o in _as_tuple(out))
            max_abs[f"{label}:{fam}"], _ = check_against_plain(
                f"{tag} API vs plain ({PARITY_STATES} states)",
                got_head if len(got_head) > 1 else got_head[0], plain, m,
                cols)
            del out
        m64 = m.to(dtype=torch.float64)
        s64 = [x[:MD_FD_STATES].double().T.contiguous() for x in s]
        if "fd_grad" in fams:
            fd_grad = md_route(m, "fd_grad")[2]
            md_solve_check(f"phaseM {label}", m64, s64, fd_grad)
            md_fd_check(f"phaseM {label}", m64, s64, fd_grad)
            if not _build.md_dense_grads(m.nv):
                md_route_check(f"phaseM {label}", m64, s64)
        if "crba" in fams:
            md_crba_check(f"phaseM {label}", m64, s64)
    return launches, max_abs, models, states


# ---------------------------------------------------------------- phase 3
def time_ms(fn, args, calls=TIMED_CALLS, warmup=2):
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_plain_ms(fn, args):
    """A plain version's time: one call after a first one (the warm-up).
    A reference, not a claim: it is timed once to keep the script within
    its budget."""
    fn(*args)
    torch.cuda.synchronize()
    return time_ms(fn, args, calls=1, warmup=0)


class OpCount(TorchDispatchMode):
    """Counts the arithmetic a plain version's function needs, element by
    element of each output. An add, sub, mul or div counts only where every
    operand is neither 0 nor (for a factor or divisor) ±1: a term that is a
    structural zero — of the robot's constants, of a ∂-column outside a
    joint's root path, the 0 Python's ``sum`` starts from, or a 0/1 mask
    and the blends made with it — is one a code specialised on the topology
    skips. sqrt, reciprocal, sin and cos count every element; a negation is
    free (a sign flip folds into the operation that uses it), and so are
    copies, selects and stacks. An FMA is two. Under forward-mode AD
    (``ops.so.jvp``) the tangent arithmetic runs as aten operations too and
    is counted alike, a zero tangent's terms skipped."""

    _BINARY = {"add", "sub", "rsub", "mul", "div"}
    _UNARY = {"reciprocal", "sqrt", "sin", "cos"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    @staticmethod
    def _mask(x, unit):
        """Where the tensor ``x`` is a real term: nonzero, and not ±1 if
        ``unit``."""
        live = x != 0
        return live & (x != 1) & (x != -1) if unit else live

    @staticmethod
    def _live_number(x, unit):
        return x != 0 and not (unit and x in (1, -1))

    def _needed(self, name, args):
        a, b = args[0], args[1]
        # mul: free where a factor is 0 or ±1; div (a / b): where a = 0 or
        # b = ±1; a ± b: where either is 0
        unit_a, unit_b = name == "mul", name in ("mul", "div")
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if not (ta and tb):
            # a number operand: live or not, everywhere
            (x, ux), (n, un) = (((a, unit_a), (b, unit_b)) if ta
                                else ((b, unit_b), (a, unit_a)))
            if not self._live_number(n, un):
                return 0
            if not isinstance(x, torch.Tensor):
                return int(self._live_number(x, ux))
            return int(self._mask(x, ux).sum()) if ux else int(
                torch.count_nonzero(x))
        return int((self._mask(a, unit_a) & self._mask(b, unit_b)).sum())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta"
               for a in args):
            # shape propagation (forward AD runs some on meta tensors): no
            # arithmetic
            return func(*args, **(kwargs or {}))
        if name in self._BINARY:
            self.ops += self._needed(name, args)   # before an in-place op
        out = func(*args, **(kwargs or {}))
        if name in self._UNARY:
            self.ops += out.numel()
        return out


def ops_per_state(plain, m, make_args, states=1):
    """Operations a state: the count at B = 1 + ``states`` less the count
    at B = 1 (the constant-only work drops out), over ``states``, on CPU
    tensors of random states — more than one where the work depends on
    the state (a ground step's inactive contacts)."""
    mc = m.to(device="cpu", dtype=torch.float64)
    counts = []
    for B in (1, 1 + states):
        args = make_args(mc, B)
        with OpCount() as c:
            plain(mc, *args)
        counts.append(c.ops)
    return (counts[1] - counts[0]) / states


@functools.lru_cache(maxsize=None)
def _count_model(kind, label):
    """A timed model rebuilt on the CPU in float32, as phase 3 builds it on
    the card (ops_per_state counts on its float64 copy)."""
    if kind == "md":
        return md_model(label, device="cpu")
    if kind == "ff":
        return ff_model(label, device="cpu")
    if kind == "md_step":
        return md_step_model(label, device="cpu")
    return gt.load_robot({**HESS_ROUTE_ROBOTS, **ROBOTS}[label],
                         dtype=torch.float32, device="cpu")


def count_jobs():
    """Every operation count phase 3 reads, as ``"label:name"`` (the
    arguments of time_entry and time_so_entry) → a thunk giving the counts
    to take, each (function, CPU model, make_args, states): the plain
    version's (ABA's for the two FD variants: the least work for q̈), then
    the work the bound takes off it (a stance's repeated
    primal; a second-order kernel's primal, taken off once per direction).
    The counting child (count_ops_child) runs them all."""
    jobs = {}

    def add(key, *counts):
        jobs[key] = lambda: [(fn, _count_model(*mk), make, k)
                             for fn, mk, make, k in counts]
    for name in ("fd_grad", "id_grad", "minv", "inverse_dynamics"):
        _, _, plain, k = PAIRS[name]
        add(f"iiwa14:{name}", (plain, ("robot", "iiwa14"), _cpu_states(k), 1))
    add("iiwa14:aba", (ABA[2], ("robot", "iiwa14"), _cpu_states(3), 1))
    for name in ("inverse_dynamics", "aba"):
        pair = ABA if name == "aba" else PAIRS[name]
        add(f"atlas:{name}",
            (pair[2], ("robot", "atlas"), _cpu_states(pair[3]), 1))
    for name, (_, _, plain, _) in staged_pairs()[1].items():
        add(f"atlas:{name}",
            (plain, ("robot", "atlas"), _staged_cpu_args(name), 1))
    # q̈ = FD(q, q̇, u) takes the fewest operations by ABA: the composition
    # FD and the factor-solve FD are bounded by ABA's count, not their own
    least = {"fd": ABA[2], "fd_dense": ABA[2]}
    for name, (_, _, plain, _) in VARIANT_PAIRS.items():
        add(f"iiwa14:{name}", (least.get(name, plain), ("robot", "iiwa14"),
                               _cpu_states(3), 1))
    for name, (_, _, plain, _) in variant_pairs()[1].items():
        add(f"atlas:{name}",
            (least.get(name, plain), ("robot", "atlas"),
             _staged_cpu_args(name, variant_pairs), 1))
    so_cache = {}
    for name, label in (("hessian_vp", SMALL_SO_ROBOT), ("hessian", "iiwa14"),
                        ("t1_q", "atlas"), ("t2", "atlas"), ("t4_q", "atlas"),
                        ("t5_q_q", "atlas")):
        plain = (HESS_PAIRS[name][2] if name in HESS_PAIRS
                 else so_stage_pairs()[1][name][2])
        make = _so_cpu_args(name, so_cache)
        add(f"{label}:{name}", (plain, ("robot", label), make, 1),
            (SO_PRIMALS[name][0], ("robot", label), make, 1))
    for name, (label, fam) in MD_TIMED.items():
        _, _, plain, k = MD_PAIRS[name]
        add(f"{label}:{name}", (plain, ("md", label), _md_cpu_states(k), 1))
    for name in MD_STAGED_TIMED:
        add(f"free_atlas:{name}", (md_staged_pairs()[1][name][2],
                                   ("md", "free_atlas"),
                                   _md_staged_cpu_args(name), 1))
    for name, (label, entry) in FF_TIMED.items():
        _, _, plain, wp = ff_pairs(label)[ff_entries(label)[entry][2]]
        make = _ff_cpu_states(label, wp)
        add(f"{label}:{name}", (plain, ("ff", label), make, 1),
            *([(stance_primal_repeat(label), ("ff", label), make, 1)]
              if wp else []))
    for name, cell in STEP_TIMED.items():
        label, grid = STEP_PATHS[cell]
        add(f"{cell}:{name}",
            (step_fns(label, grid, False, torch.float32, "cpu")[1],
             ("ff", label), _step_cpu_states(label), STEP_OPS_STATES))
    add("md_ball_ant:md_step_ground",
        (md_step_fns("ball_ant", True, False, torch.float32, "cpu")[1],
         ("md_step", "ball_ant"), _md_cpu_step_states, STEP_OPS_STATES))
    add("hyq_geoms:step_ground[hyq_geoms]",
        (step_fns("hyq", None, False, torch.float32, "cpu", geoms=True)[1],
         ("ff", "hyq"), _geoms_cpu_states, STEP_OPS_STATES))
    for case in ROWS_PATHS:
        add(f"{case}:step_ground[{case}]",
            (rows_fns(case, torch.float32, "cpu")[1],
             ("ff", ROWS_CASES[case][0]), _rows_cpu_states(case),
             STEP_OPS_STATES))
    return jobs


def count_ops_child():
    """``chip_smoke.py --count-ops``: every count of count_jobs on the CPU
    (started with no visible CUDA device), printed as one JSON line
    {key: [counts], "seconds": s} — run beside the GPU phases."""
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    out = {key: [ops_per_state(*c) for c in job()]
           for key, job in count_jobs().items()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


class OpCounts:
    """The counting child: started after main()'s builds, read at the
    first bound phase 3 writes."""

    def __init__(self):
        self.proc, self.counts, self.t0 = None, None, None

    def start(self):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--count-ops"],
            stdout=subprocess.PIPE, text=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})

    def get(self, key):
        if self.counts is None:
            w0 = time.perf_counter()
            out, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(f"the counting child failed "
                                   f"({self.proc.returncode})")
            self.counts = json.loads(out.strip().splitlines()[-1])
            waited = time.perf_counter() - w0
            log(f"operation counts: the child took "
                f"{self.counts['seconds']:.1f} s beside the GPU phases "
                f"(started {w0 - self.t0:.1f} s before its first read, "
                f"waited {waited:.1f} s for it): {self.counts['seconds'] - waited:.1f}"
                f" s of wall time saved")
        return list(self.counts[key])


    def stop(self):
        """End the child if it still runs (a phase failed before phase 3
        read it)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


COUNTS = OpCounts()


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(ops, bytes_):
    """(bound ms, what sets it): the larger of the operations over the
    float32 rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cpu_states(k, extra=None):
    """make_args for ops_per_state: k random (n, B) states in bench.py's
    ranges, from SEED [+ the staged inputs built from them]."""
    def make(mc, B):
        gen = torch.Generator().manual_seed(SEED)
        st = [(torch.rand((mc.n, B), generator=gen, dtype=torch.float64)
               * 2 - 1) * r for r in (2.0, 1.0, 8.0)[:k]]
        return st if extra is None else extra(mc, B, st)
    return make


def _staged_cpu_args(name, pairs=staged_pairs):
    """make_args of a staged_pairs (or variant_pairs) stage: random CPU
    states and the plain upstream stages' outputs on them."""
    def extra(mc, B, st):
        up, spairs = pairs()
        return spairs[name][3](st, up(mc, *st))
    return _cpu_states(3, extra)


def time_entry(label, name, kern, plain, m, args, name_limit, const_bytes=0,
               count=None, plain_ms=None):
    """Time a kernel and its plain version (plain, kernel, kernel, plain in
    one call), and its bound at these inputs: the plain version's
    operations a state (count_jobs' ``label:name``: averaged over its
    states, less a repeat — work the plain version does a second time, a
    forward-mode pass re-evaluating its primal, which the least work does
    once); bytes: the inputs and outputs, and ``const_bytes`` read once (a
    height grid). ``count`` names the count, and ``plain_ms`` gives the
    plain version's time, where both are another kernel's (a second design
    of the same function at the same shapes)."""
    p1 = plain_ms or time_plain_ms(plain, (m, *args))
    k1 = time_ms(kern, (m, *args))
    k2 = time_ms(kern, (m, *args))
    p2 = plain_ms or time_plain_ms(plain, (m, *args))
    outs = _as_tuple(kern(m, *args))
    total, again = (COUNTS.get(f"{label}:{count or name}") + [0])[:2]
    ops = (total - again) * args[0].shape[-1]
    nb = nbytes(*args, *outs) + const_bytes
    b_ms, b_by = bound(ops, nb)
    k, p = min(k1, k2), min(p1, p2)
    log(f"phase3 {name} {label} f32 B={args[0].shape[-1]}: kernel "
        f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms (median of "
        f"{TIMED_CALLS} / 1); bound {b_ms:.3f} ms by {b_by} "
        f"({ops:.3e} ops = ({total:g} − {again:g}) a state, {nb:.3e} B, "
        f"{nb / args[0].shape[-1]:.0f} B a state; roofline share "
        f"{b_ms / k:.1%}); card {name_limit}")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by)


def profile_breakdown(fn, args, label, name_limit, calls=3):
    """Device time by kernel over ``calls`` calls (torch.profiler), and the
    busy share of the window. A trace that holds fewer launches of its
    longest kernel than there were calls has lost events: it is taken once
    more, and if it is short again its shares are not measured."""
    fn(*args)
    torch.cuda.synchronize()
    for attempt in (1, 2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            for _ in range(calls):
                fn(*args)
            b.record()
            b.synchronize()
        window = a.elapsed_time(b)
        # device kernels only: an aten op's row repeats its kernels' time
        rows = []
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            if dev > 0 and (getattr(e, "device_type", None) == DeviceType.CUDA
                            or not e.key.startswith(("aten::", "cuda"))):
                rows.append((e.key, dev / 1e3, e.count))
        if not rows:
            log(f"phase3 profile {label}: no device time in the trace (not "
                f"measured)")
            return
        top = max(rows, key=lambda r: r[1])
        if top[2] >= calls:
            break
        log(f"phase3 profile {label}: the trace holds {top[2]} launches of "
            f"its longest kernel for {calls} calls (attempt {attempt}: "
            f"events lost)")
    else:
        log(f"phase3 profile {label}: breakdown not measured")
        return
    busy = sum(r[1] for r in rows)
    log(f"phase3 profile {label} ({calls} calls, window {window:.3f} ms, "
        f"device busy {busy:.3f} ms = {busy / window:.1%}; card "
        f"{name_limit}):")
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms / calls:9.3f} ms/call {ms / busy:6.1%} x{cnt // calls} "
            f"{key[:100]}")


def phase3_times(m, mA, atlas_states, gen):
    name_limit = card()
    times = {}
    q, qd, u = uniform_states(m.n, MAIN_B, torch.float32, gen)
    for name in ("fd_grad", "id_grad", "minv", "inverse_dynamics"):
        _, kern, plain, k = PAIRS[name]
        times[name] = time_entry("iiwa14", name, kern, plain, m,
                                 (q, qd, u)[:k], name_limit)
    times["aba"] = time_entry("iiwa14", "aba", ABA[1], ABA[2], m, (q, qd, u),
                              name_limit)
    qb, qdb, ub = (x.T.contiguous() for x in (q, qd, u))
    for fn in (gt.forward_dynamics_gradient, gt.forward_dynamics):
        api = time_ms(fn, (m, qb, qdb, ub))
        log(f"phase3 {fn.__name__} API iiwa14 B={MAIN_B}: {api:.3f} ms "
            f"({MAIN_B / api * 1e3:.3e} evals/s); card {name_limit}")

    # Atlas: every stage kernel at its main-path shape, on the path's own
    # intermediates
    s = [x.T.contiguous() for x in atlas_states]
    for name in ("inverse_dynamics", "aba"):
        pair = ABA if name == "aba" else PAIRS[name]
        times[f"{name}[atlas]"] = time_entry(
            "atlas", name, pair[1], pair[2], mA, tuple(s[:pair[3]]),
            name_limit)
    _, spairs = staged_pairs()
    x = {}
    x["c"], x["v"] = staged.bias_and_v_staged(mA, s[0], s[1])
    x["Minv"], x["qdd"] = staged.minv_qdd_dense_staged(mA, s[0],
                                                       s[2] - x["c"])
    x["a"], x["f"] = staged.af_staged(mA, s[0], s[1], x["qdd"], x["v"])
    x["v2"], x["a2"], x["f2"] = staged.vaf_staged(mA, *s)
    for name, (_, kern, plain, inputs) in spairs.items():
        times[name] = time_entry("atlas", name, kern, plain, mA,
                                 tuple(inputs(s, x)), name_limit)
    # K2′'s yardstick: the batched factor, inverse (and solve) on the same
    # CRBA matrices
    times["minv_dense"]["library_ms"] = chol_library_ms(
        "minv_dense atlas", mA, s[0], s[2] - x["c"], name_limit,
        inverse=True)
    times["minv_dense_norhs"]["library_ms"] = chol_library_ms(
        "minv_dense_norhs atlas", mA, s[0], None, name_limit)
    del x
    qa, qda, ua = atlas_states
    for fn in (gt.forward_dynamics_gradient, gt.inverse_dynamics_gradient,
               gt.direct_minv, gt.forward_dynamics):
        k = 1 if fn is gt.direct_minv else 3
        api = time_ms(fn, (mA, qa, qda, ua)[:k + 1])
        log(f"phase3 {fn.__name__} API atlas B={MAIN_B}: {api:.3f} ms "
            f"({MAIN_B / api * 1e3:.3e} evals/s); card {name_limit}")
    atlas_profile()
    return times


def atlas_profile():
    """The profiler breakdown of Atlas's ∇FD through the API at MAIN_B,
    taken in a child process (torch.profiler loses events after this
    process's earlier traces)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--atlas-profile"],
        capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        raise RuntimeError(f"profile child failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")


def atlas_profile_child():
    """atlas_profile's child: loads the library the parent built and traces
    ``forward_dynamics_gradient``."""
    m = gt.load_robot(ROBOTS["atlas"], dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    s = uniform_states(m.n, MAIN_B, torch.float32, gen, layout="Bn")
    profile_breakdown(gt.forward_dynamics_gradient, (m, *s),
                      "forward_dynamics_gradient atlas (a fresh process)",
                      card())


def _so_cpu_args(name, cache):
    """make_args for ops_per_state of a second-order kernel: random CPU
    states (q, q̇, u, λ) and, for a tangent stage, the plain upstream
    stages' outputs on them (kept in ``cache`` for the next stage)."""
    def make(mc, B):
        key = (mc.n, B)
        if key not in cache:
            gen = torch.Generator().manual_seed(SEED)
            s = [(torch.rand((mc.n, B), generator=gen, dtype=torch.float64)
                  * 2 - 1) * r for r in (2.0, 1.0, 8.0, 1.0)]
            cache[key] = (s, None if name in HESS_PAIRS
                          else so_stage_pairs()[0](mc, *s))
        s, x = cache[key]
        if name in HESS_PAIRS:
            return s[:HESS_PAIRS[name][3]]
        return list(so_stage_pairs()[1][name][3](s, x))
    return make


def time_so_entry(label, name, kern, plain, m, args, name_limit):
    """Time a second-order kernel and its plain version (once, on
    the first B / PLAIN_SO_DIV states, scaled to B), and its bound: the
    plain version's operations less the primal's repeats (both versions
    recompute the primal for every direction; the least work does it once
    a state)."""
    B = args[0].shape[-1]
    Bp = B // PLAIN_SO_DIV
    pargs = tuple(a[..., :Bp].contiguous() for a in args)
    w0 = time.perf_counter()
    p = time_plain_ms(plain, (m, *pargs)) * PLAIN_SO_DIV
    w1 = time.perf_counter()
    k = time_ms(kern, (m, *args))
    outs = _as_tuple(kern(m, *args))
    w2 = time.perf_counter()
    _, dirs = SO_PRIMALS[name]
    total, once = COUNTS.get(f"{label}:{name}")
    log(f"phase3 {name} {label}: wall {w1 - w0:.1f} s plain, {w2 - w1:.1f} "
        f"s kernel, {time.perf_counter() - w2:.1f} s waiting for the "
        f"operation count")
    ops = (total - (dirs * m.n - 1) * once) * B
    b_ms, b_by = bound(ops, nbytes(*args, *outs))
    log(f"phase3 {name} {label} f32 B={B}: kernel {k:.3f} ms "
        f"(median of {TIMED_CALLS}), plain {p:.3f} ms (scaled ×"
        f"{PLAIN_SO_DIV} from B={Bp}, one call); bound {b_ms:.3f} ms"
        f" by {b_by} ({ops:.3e} ops = ({total:g} − ({dirs * m.n} − 1)·"
        f"{once:g}) "
        f"a state, {nbytes(*args, *outs):.3e} B; roofline share "
        f"{b_ms / k:.1%}); card {name_limit}")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by)


def api_ms(fn, args, label, name_limit):
    """An API call's median time: 10 calls, or 3 where one takes over 1 s."""
    w0 = t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    calls = TIMED_CALLS if time.perf_counter() - t0 < 1.0 else 3
    ms = time_ms(fn, args, calls=calls, warmup=1)
    B = args[1].shape[0]
    log(f"phase3 {fn.__name__} API {label} B={B}: {ms:.3f} ms (median of "
        f"{calls}; {B / ms * 1e3:.3e} evals/s; wall "
        f"{time.perf_counter() - w0:.1f} s); card {name_limit}")
    return ms


def phase3_second_order(mA, sA, gen):
    """Times of the second-order kernels at phase H's shapes, the API times,
    and a profiler breakdown of Atlas's λᵀ·H by stage."""
    name_limit = card()
    times = {}
    for name, label in (("hessian_vp", SMALL_SO_ROBOT),
                        ("hessian", "iiwa14")):
        _, kern, plain, k = HESS_PAIRS[name]
        m = gt.load_robot({**HESS_ROUTE_ROBOTS, **ROBOTS}[label],
                          dtype=torch.float32, device="cuda")
        s = uniform_states(m.n, HESS_B, torch.float32, gen)
        s.append(uniform_lam(m.n, HESS_B, torch.float32, gen))
        times[name] = time_so_entry(label, name, kern, plain, m, s[:k],
                                    name_limit)
        sb = [x.T.contiguous() for x in s]
        api_ms(gt.forward_dynamics_hessian_vp, (m, *sb), label, name_limit)
    for fn in (gt.forward_dynamics_hessian, gt.forward_dynamics_gradient_full):
        api_ms(fn, (m, *sb[:3]), "iiwa14", name_limit)
    del s, sb

    # Atlas: each tangent stage at its pipeline shape, on the pipeline's
    # own kernel intermediates
    sc = [x.T.contiguous() for x in sA]
    q, qd, u, lam = sc
    x = {}
    c, x["v"] = staged.bias_and_v_staged(mA, q, qd)
    x["Minv"], x["qdd"] = staged.minv_qdd_dense_staged(mA, q, u - c)
    x["a"], x["f"] = staged.af_staged(mA, q, qd, x["qdd"], x["v"])
    x["lamM"] = torch.einsum("ijb,jb->ib", x["Minv"], lam).contiguous()
    x["dc0"], x["dv0"] = so_staged.t1_staged(mA, q, qd, 0)
    x["dlamM"], x["dqdd0"] = so_staged.t2_staged(mA, q, x["lamM"], x["qdd"],
                                                 x["Minv"], x["dc0"])
    x["da0"], x["df0"] = so_staged.t4_staged(mA, q, qd, x["qdd"], x["v"],
                                             x["dv0"], x["dqdd0"], 0)
    _, pairs = so_stage_pairs()
    for name in ("t1_q", "t2", "t4_q", "t5_q_q"):
        _, kern, plain, inputs = pairs[name]
        times[name] = time_so_entry("atlas", name, kern, plain, mA,
                                    tuple(inputs(sc, x)), name_limit)
    del x
    api_ms(gt.forward_dynamics_hessian_vp, (mA, *sA), "atlas", name_limit)
    profile_breakdown(gt.forward_dynamics_hessian_vp, (mA, *sA),
                      "forward_dynamics_hessian_vp atlas", name_limit)
    return times


def phase3_hessian_routes(gen):
    """λᵀ·H of the robots in HESS_ROUTE_ROBOTS on both routes — the
    single-thread kernel and the staged pipeline — each held to its plain
    version in float64, then timed single, staged, staged, single: where
    MAX_HESSIAN_VP_JOINTS goes. At HyQ the full H too (the staged route's
    is n λᵀ·H calls): MAX_HESSIAN_JOINTS."""
    name_limit = card()
    for label, urdf in HESS_ROUTE_ROBOTS.items():
        m = gt.load_robot(urdf, dtype=torch.float32, device="cuda")
        s = uniform_states(m.n, HESS_B, torch.float32, gen)
        s.append(uniform_lam(m.n, HESS_B, torch.float32, gen))
        m64 = m.to(dtype=torch.float64)
        s64 = [x[:, :ROUTE_SO_STATES].double().contiguous() for x in s]
        routes = {"single": (so_fused.fd_hessian_vp_fused,
                             so_fused.fd_hessian_vp_plain),
                  "staged": (so_staged.fd_hessian_vp_staged,
                             so_staged.fd_hessian_vp_staged_plain)}
        for route, (kern, plain) in routes.items():
            check_against_plain(
                f"phase3 routes {label} (n={m.n}) {route} λᵀ·H f64 "
                f"({ROUTE_SO_STATES} states)", kern(m64, *s64), plain, m64,
                s64)
        ms = {r: [] for r in routes}
        for r in ("single", "staged", "staged", "single"):
            ms[r].append(time_ms(routes[r][0], (m, *s), calls=5))
        log(f"phase3 routes {label} (n={m.n}, T5 cb "
            f"{_build.so_col_block(m.n)}) λᵀ·H f32 B={HESS_B}: "
            + "; ".join(f"{r} {a:.3f}/{b:.3f} ms"
                        for r, (a, b) in ms.items())
            + f"; card {name_limit}")
        if label == "hyq":
            full = {"single": so_fused.fd_hessian_fused,
                    "staged": so_staged.fd_hessian_staged}
            t = {r: time_ms(full[r], (m, *s[:3]), calls=3, warmup=1)
                 for r in ("single", "staged")}
            log(f"phase3 routes {label} full H f32 B={HESS_B}: single "
                f"{t['single']:.3f} ms; staged ({m.n} λᵀ·H calls) "
                f"{t['staged']:.3f} ms (median of 3); card {name_limit}")
        del s, s64


def phase3_k5_width(mA, atlas_states):
    """Atlas's one-thread K5 with the finish (the width sets its column
    blocks; the tile takes every column at once) at column blocks of 4 (the
    built width) and 2 (the 7-wide build timed when the width was chosen is
    in PERF.md)."""
    name_limit = card()
    q, qd, u = (x.T.contiguous() for x in atlas_states)
    c, v = staged.bias_and_v_staged(mA, q, qd)
    Minv, qdd = staged.minv_qdd_dense_staged(mA, q, u - c)
    a, f = staged.af_staged(mA, q, qd, qdd, v)
    with design("thread"):
        ms = [(cb, time_ms(lambda: staged.grad_cols_staged(
            mA, q, qd, v, a, f, cb=cb, Minv=Minv), ())) for cb in (4, 2)]
    log(f"phase3 one-thread K5 with the finish, Atlas f32 B={q.shape[-1]}: "
        + "; ".join(f"cb {w} {t:.3f} ms" for w, t in ms)
        + f"; card {name_limit}")


def phase3_routes(gen):
    """∇FD of robots at and under MAX_KERNEL_JOINTS on both routes — the
    single-thread kernel and the staged pipeline — each held to its plain
    version, then timed single, staged, staged, single: where the routes
    cross over."""
    name_limit = card()
    for label, urdf in ROUTE_ROBOTS.items():
        m = gt.load_robot(urdf, dtype=torch.float32, device="cuda")
        q, qd, u = uniform_states(m.n, MAIN_B, torch.float32, gen)
        # checked in float64: the float32 rule's plain error is itself
        # conditioning at these depths
        m64 = m.to(dtype=torch.float64)
        s = [x[:, :COMPARE_STATES].double().contiguous() for x in (q, qd, u)]
        routes = {"single": (fused.fd_grad_fused, fused.fd_grad_plain),
                  "staged": (staged.fd_grad_staged, staged.fd_grad_plain)}
        for route, (kern, plain) in routes.items():
            check_against_plain(
                f"phase3 routes {label} (n={m.n}) {route} ∇FD f64 "
                f"({COMPARE_STATES} states)", kern(m64, *s), plain, m64, s)
        ms = {r: [] for r in routes}
        for r in ("single", "staged", "staged", "single"):
            ms[r].append(time_ms(routes[r][0], (m, q, qd, u)))
        log(f"phase3 routes {label} (n={m.n}, K5 cb "
            f"{_build.default_col_block(m.n)}) ∇FD f32 B={MAIN_B}: "
            + "; ".join(f"{r} {a:.3f}/{b:.3f} ms" for r, (a, b) in ms.items())
            + f"; card {name_limit}")
        del q, qd, u


def _md_cpu_states(k):
    """make_args for ops_per_state of a multi-dof kernel: k random states
    (q on the manifold (nq, B), then q̇ and u (nv, B)) from SEED."""
    def make(mc, B):
        gen = torch.Generator().manual_seed(SEED)
        def uni(r):
            return (torch.rand((B, mc.nv), generator=gen,
                               dtype=torch.float64) * (2 * r) - r)
        q = gt.md_tangent_apply(mc, gt.neutral_q(mc).expand(B, -1), uni(0.6))
        return [x.T.contiguous() for x in (q, uni(0.8), uni(5.0))][:k]
    return make


def _md_staged_cpu_args(name):
    """make_args for ops_per_state of a staged multi-dof kernel: random CPU
    states and the plain upstream stages' outputs on them."""
    def make(mc, B):
        st = _md_cpu_states(3)(mc, B)
        up, pairs = md_staged_pairs()
        return list(pairs[name][3](st, up(mc, *st)))
    return make


# JSON name → (phase-M robot, family): where each kernel of md.cu is timed
MD_TIMED = {"md_fd_grad": ("free_iiwa14", "fd_grad"),
            "md_id_grad": ("free_iiwa14", "id_grad"),
            "md_id": ("free_atlas", "id"), "md_aba": ("free_atlas", "aba"),
            "md_fd": ("free_atlas", "crba")}
# the staged multi-dof kernels, timed on free Atlas's path
MD_STAGED_TIMED = ("md_minv_qdd", "md_minv", "md_vaf", "md_grad_cols_finish",
                   "md_grad_cols")


def phase3_multidof(models, states, gen):
    """Times of the multi-dof kernels and their plain versions at phase M's
    shapes — the staged ones on free Atlas's own kernel intermediates —,
    their bounds, the API times, free Atlas's K5md at three column widths,
    and profiler breakdowns of free Atlas's ∇FD and ∂ID by stage."""
    name_limit = card()
    times = {}
    for name, (label, fam) in MD_TIMED.items():
        _, kern, plain, k = MD_PAIRS[name]
        m, s = models[label], states[label]
        cols = tuple(x.T.contiguous() for x in s[:k])
        times[name] = time_entry(label, name, kern, plain, m, cols,
                                 name_limit)
        del cols
    m = models["free_atlas"]
    cols = [x.T.contiguous() for x in states["free_atlas"]]
    q, qd, u = cols
    x = {}
    x["Minv"], x["qdd"] = mds.md_minv_qdd_fused(m, q, qd, u)
    x["v"], x["a"], x["f"] = mds.md_vaf_staged(m, q, qd, x["qdd"])
    x["v2"], x["a2"], x["f2"] = mds.md_vaf_staged(m, q, qd, u)
    _, pairs = md_staged_pairs()
    for name in MD_STAGED_TIMED:
        _, kern, plain, inputs = pairs[name]
        times[name] = time_entry("free_atlas", name, kern, plain, m,
                                 tuple(inputs(cols, x)), name_limit)
    ms = [(cb, time_ms(lambda: mds.md_grad_cols_staged(
        m, q, qd, x["v"], x["a"], x["f"], cb=cb, Minv=x["Minv"]), ()))
        for cb in MD_CB_WIDTHS]
    log(f"phase3 K5md with the finish, free Atlas f32 B={MAIN_B} (built "
        f"width {_build.md_col_block(m.n, m.nv)}): "
        + "; ".join(f"cb {w} {t:.3f} ms" for w, t in ms)
        + f"; card {name_limit}")
    del x, cols, q, qd, u
    for label, fams in MD_PATHS.items():
        for fam in fams:
            fn, k = MD_API[fam]
            api_ms(fn, (models[label], *states[label][:k]),
                   f"{label} {fam}", name_limit)
    md_profile("free_atlas")
    return times


def md_profile(label):
    """Profiler breakdowns of ``label``'s ∇FD and ∂ID at MAIN_B, taken in a
    child process: in this one, after the earlier traces, torch.profiler
    loses events (PERF.md §7), and a fresh process holds them."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--md-profile",
         label], capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        raise RuntimeError(f"profile child failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")


def md_profile_child(label):
    """md_profile's child: loads the libraries the parent built (under the
    same route limits, so the same build keys) and traces both gradient
    entries."""
    with route_limits():
        m = md_model(label)
        _build.library(m, _with_staged(m))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    s = md_states(m, MAIN_B, gen, layout="Bn")
    name_limit = card()
    for fn in (gt.md_forward_dynamics_gradient_batched,
               gt.md_id_grad_batched):
        profile_breakdown(fn, (m, *s), f"{fn.__name__} {label} (a fresh "
                          f"process)", name_limit)


def phase3_md_routes(gen):
    """∇FD and ∂ID of MD_ROUTE_ROBOTS on both routes — the single-thread
    kernels and the staged pipeline, each built here whatever
    MAX_MD_GRAD_NV is — each held to its plain version in float64, then
    timed single, staged, staged, single at MD_ROUTE_B: where
    MAX_MD_GRAD_NV goes."""
    name_limit = card()
    routes = {
        "∇FD": {"single": (mdf.md_fd_grad_fused, mdf.md_fd_grad_plain),
                "staged": (mds.md_fd_grad_staged,
                           mds.md_fd_grad_staged_plain)},
        "∂ID": {"single": (mdf.md_id_grad_fused, mdf.md_id_grad_plain),
                "staged": (mds.md_id_grad_staged,
                           mds.md_id_grad_staged_plain)},
    }
    for label in MD_ROUTE_ROBOTS:
        m = md_model(label)
        s = md_states(m, MD_ROUTE_B, gen)
        m64 = m.to(dtype=torch.float64)
        s64 = [x[:, :PARITY_STATES].double().contiguous() for x in s]
        for fam, pair in routes.items():
            for route, (kern, plain) in pair.items():
                check_against_plain(
                    f"phase3 md routes {label} (nv={m.nv}) {route} {fam} f64 "
                    f"({PARITY_STATES} states)", kern(m64, *s64), plain, m64,
                    s64)
            ms = {r: [] for r in pair}
            for r in ("single", "staged", "staged", "single"):
                ms[r].append(time_ms(pair[r][0], (m, *s), calls=5))
            log(f"phase3 md routes {label} (n={m.n}, nv={m.nv}, K5md cb "
                f"{_build.md_col_block(m.n, m.nv)}) {fam} f32 "
                f"B={MD_ROUTE_B}: "
                + "; ".join(f"{r} {a:.3f}/{b:.3f} ms"
                            for r, (a, b) in ms.items())
                + f"; card {name_limit}")
        del s, s64


# ---------------------------------------------------------------- phase F
def fb_forward_dynamics_batched_aba(m, quat, q, vb, qd, tau):
    return tff.fb_forward_dynamics_batched(m, quat, q, vb, qd, tau)


def fb_forward_dynamics_batched_chol(m, quat, q, vb, qd, tau):
    return tff.fb_forward_dynamics_batched(m, quat, q, vb, qd, tau,
                                           impl="chol")


def ff_entries(label):
    """Phase F's calls: entry → (public function of (model, batch-first
    states), the launches one call makes, the ff_pairs kernel it runs)."""
    links, off, _ = ff_geometry(label)

    def fb_constrained_fd_batched(m, *s):
        return tct.fb_constrained_fd_batched(m, *s, links, off)
    return {"aba": (fb_forward_dynamics_batched_aba, {"fb_aba": 1},
                    "fb_aba"),
            "chol": (fb_forward_dynamics_batched_chol, {"fb_fd": 1},
                     "fb_fd"),
            "stance": (fb_constrained_fd_batched, {"stance_fd": 1},
                       "stance_fd")}


def stance_residuals(ffm, quat, pos, q, vb, qd, tau, dvb, qdd, lam, links,
                     offsets, anchors=None, gravity=-9.81,
                     baumgarte=(0.0, 0.0)):
    """How far a stance solution (v̇b, q̈, λ), batch-last, is from its two
    equations, per state relative to max(1, |terms|): the constraint
    J·[v̇b; q̈] + J̇·[vb; q̇] − a* (→ (B,)) and the dynamics M·[v̇b; q̈] −
    [−f_b; τ − c_j] − Jᵀλ (→ (B,)), built from the plain pieces."""
    m = 6 + ffm.n
    X = blops.joint_transforms_bl(ffm.arm, q)
    R = cff._quat_rot_s(quat)
    f_b, c_j = cff._fb_bias_s(ffm, X, R, vb, qd, gravity)
    zero = torch.zeros_like(q[0:1])

    def dense(rows):
        return torch.stack([torch.cat([zero if e is None else e
                                       for e in row]) for row in rows])

    M = dense(cff._fb_mass_s(ffm, X))                       # (m, m, B)
    Jl, xs = cff._ff_contact_rows_s(ffm, X, R, links, offsets)
    J = dense(Jl)                                           # (3k, m, B)
    y = torch.cat([dvb, qdd])
    bias = cff._contact_bias(ffm, quat, q, vb, qd, links, offsets)
    a_star = cff._baumgarte(cff._jt_stacks(Jl, m, zero),
                            cff._vfull_list(ffm, vb, qd), R, pos, xs,
                            anchors, baumgarte)
    a_star = torch.zeros_like(bias) if a_star is None else a_star
    Jy = torch.einsum("rcb,cb->rb", J, y)
    con = (Jy + bias - a_star).abs().amax(0) / torch.stack(
        [Jy.abs().amax(0), bias.abs().amax(0), a_star.abs().amax(0)]
    ).amax(0).clamp(min=1.0)
    My = torch.einsum("rcb,cb->rb", M, y)
    rhs = torch.cat(cff._rhs_free(f_b, c_j, tau))
    Jtl = torch.einsum("rcb,rb->cb", J, lam)
    dyn = (My - rhs - Jtl).abs().amax(0) / torch.stack(
        [My.abs().amax(0), rhs.abs().amax(0), Jtl.abs().amax(0)]
    ).amax(0).clamp(min=1.0)
    return con, dyn


def ff_physics(tag, label, m64, s64):
    """Float64 checks on a few states that do not go through a kernel's own
    plain version: ABA against the mass-matrix Cholesky, and the stance
    solutions (plain, and with Baumgarte, anchors and the ridge) against
    their two equations — the constraint J·y + J̇·v − a* (a ridge allows
    reg·max|λ|) and the dynamics M·y − [−f_b; τ − c_j] − Jᵀλ."""
    fb = ff_args(s64, False)
    aba, chol = cff.fb_aba_fused(m64, *fb), cff.fb_fd_fused(m64, *fb)
    err = compare(aba, chol)[0]
    log(f"{tag} ABA vs the mass-matrix Cholesky (f64, "
        f"{s64[0].shape[-1]} states): rel {err:.3e} (bound "
        f"{FF_ABA_CHOL_TOL:.0e}) {'ok' if err <= FF_ABA_CHOL_TOL else 'FAIL'}")
    if err > FF_ABA_CHOL_TOL:
        raise RuntimeError(f"{tag}: ABA disagrees with the Cholesky FD")
    links, off, anchors = ff_geometry(label)
    for case, kw in (("plain", {}),
                     ("baumgarte", dict(FF_BAUMGARTE, anchors=anchors))):
        dvb, qdd, lam = cff.stance_fd_fused(m64, *s64, links, off, **kw)
        con, dyn = stance_residuals(
            m64, *s64, dvb, qdd, lam, links, off, kw.get("anchors"),
            baumgarte=kw.get("baumgarte", (0.0, 0.0)))
        con_tol = FF_CON_TOL + kw.get("reg", 0.0) * float(lam.abs().max())
        con, dyn = float(con.max()), float(dyn.max())
        ok = con <= con_tol and dyn <= FF_DYN_TOL
        log(f"{tag} stance {case} residuals (f64, {s64[0].shape[-1]} "
            f"states): constraint {con:.3e} (bound {con_tol:.1e}), dynamics "
            f"{dyn:.3e} (bound {FF_DYN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{tag}: the stance solution misses its "
                               f"equations")


def phaseF_free_flyer(gen):
    """The free-flyer entry points at B = 2¹⁸, float32, on HyQ (four feet)
    and Atlas (two feet): ``fb_forward_dynamics_batched`` (ABA, and
    ``impl="chol"``) and ``fb_constrained_fd_batched``. Each call runs with
    the counts set to 0 just before it and read just after, and must make
    exactly its one launch; its peak memory; a 256-state head of each
    output against its plain version; then the float64 physics checks
    (ff_physics)."""
    launches, max_abs, states, models = {}, {}, {}, {}
    for label in FF_PATHS:
        m = ff_model(label)
        s = ff_states(m, MAIN_B, gen, label, layout="Bd")
        models[label], states[label] = m, s
        pairs = ff_pairs(label)
        for entry, (fn, expect, kname) in ff_entries(label).items():
            _, _, plain, wp = pairs[kname]
            args = ff_args(s, wp)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _launch.reset_launches()
            t0 = time.perf_counter()
            out = fn(m, *args)
            torch.cuda.synchronize()
            got = dict(_launch.LAUNCHES)
            made = {k: v for k, v in got.items() if v}
            tag = f"phaseF {label} (n={m.n}) {entry}"
            log(f"{tag} B={MAIN_B} (first call): "
                f"{time.perf_counter() - t0:.3f} s; launches {made}; peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
            if made != expect:
                raise RuntimeError(f"{tag}: launched {made}, not {expect}")
            launches[f"{label}:{entry}"] = got
            widths = (6, m.n, 3 * len(FF_ROBOTS[label][1]))
            for o, w in zip(out, widths):
                if o.device.type != "cuda" or tuple(o.shape) != (MAIN_B, w):
                    raise RuntimeError(f"{tag}: {o.device} {tuple(o.shape)}")
            check_finite(tag, out)
            cols = [x[:PARITY_STATES].T.contiguous() for x in args]
            head = tuple(o[:PARITY_STATES].T for o in out)
            max_abs[f"{label}:{entry}"], _ = check_against_plain(
                f"{tag} API vs plain ({PARITY_STATES} states)", head, plain,
                m, cols)
            del out
        ff_physics(f"phaseF {label}", label, m.to(dtype=torch.float64),
                   [x[:FF_PHYS_STATES].double().T.contiguous() for x in s])
    return launches, max_abs, models, states


# ---------------------------------------------------------- phase 3 (free)
def _ff_cpu_states(label, with_pos):
    """make_args for ops_per_state of a free-flyer kernel: random CPU
    states in phase F's ranges from SEED."""
    def make(mc, B):
        gen = torch.Generator().manual_seed(SEED)
        _, _, _, posture, spread = FF_ROBOTS[label]

        def uni(d, r):
            return torch.rand((d, B), generator=gen,
                              dtype=torch.float64) * (2 * r) - r
        quat = torch.randn((4, B), generator=gen, dtype=torch.float64)
        quat = quat / torch.linalg.vector_norm(quat, dim=0, keepdim=True)
        mean = torch.tensor(posture, dtype=torch.float64).repeat(
            mc.n // len(posture))[:, None]
        s = [quat, uni(3, 0.1), mean + uni(mc.n, spread), uni(6, 0.6),
             uni(mc.n, 0.5), uni(mc.n, 10.0)]
        return list(ff_args(s, with_pos))
    return make


def stance_primal_repeat(label):
    """The stance's bias J̇·v is the tangent of the contact velocity J·v
    (``torch.func.jvp``), whose pass evaluates J·v's primal — the support's
    transforms, R, the FK and the rows, which the stance has already formed,
    and J·v, which it does not need — a second time: counted once here, so
    that it comes off the bound."""
    links, off, _ = ff_geometry(label)

    def vel(m, quat, pos, q, vb, qd, tau):
        return cff._contact_vel(m, quat, q, cff._vfull_list(m, vb, qd),
                                links, off)
    return vel


# JSON name → (phase-F robot, entry): where each kernel of ff.cu is timed
FF_TIMED = {"fb_aba": ("atlas", "aba"), "fb_fd": ("atlas", "chol"),
            "stance_fd": ("hyq", "stance"), "fb_aba[hyq]": ("hyq", "aba"),
            "fb_fd[hyq]": ("hyq", "chol"),
            "stance_fd[atlas]": ("atlas", "stance")}


def phase3_free_flyer(models, states):
    """Times of the ff.cu kernels and their plain versions at phase F's
    shapes, their bounds, the API times, the batched Cholesky pair
    (``torch.linalg.cholesky`` + ``torch.cholesky_solve``) on the same
    mass matrices — the last step of the mass-matrix FD alone (profiler
    breakdowns of HyQ's stance and Atlas's ABA come from phase 3 ground
    step's child process, step_profile)."""
    name_limit = card()
    times = {}
    for name, (label, entry) in FF_TIMED.items():
        kname = ff_entries(label)[entry][2]
        _, kern, plain, wp = ff_pairs(label)[kname]
        m = models[label]
        cols = tuple(x.T.contiguous() for x in ff_args(states[label], wp))
        times[name] = time_entry(label, name, kern, plain, m, cols,
                                 name_limit)
        del cols
    for label in FF_PATHS:
        m, s = models[label], states[label]
        for entry, (fn, _, kname) in ff_entries(label).items():
            api_ms(fn, (m, *ff_args(s, ff_pairs(label)[kname][3])),
                   f"free {label}", name_limit)
        # the (6+n)² Cholesky pair on the mass matrices of these states
        cols = [x.T.contiguous() for x in s]
        X = blops.joint_transforms_bl(m.arm, cols[2])
        zero = torch.zeros_like(cols[2][0:1])
        M = torch.stack([torch.cat([zero if e is None else e for e in row])
                         for row in cff._fb_mass_s(m, X)])
        M = M.permute(2, 0, 1).contiguous()             # (B, 6+n, 6+n)
        rhs = torch.cat([cols[3], cols[5]]).T.contiguous()[..., None]
        del X, cols

        def chol_pair(M, rhs):
            return torch.cholesky_solve(rhs, torch.linalg.cholesky(M))
        ms = time_ms(chol_pair, (M, rhs), calls=5)
        log(f"phase3 library torch.linalg.cholesky + torch.cholesky_solve "
            f"free {label} ({M.shape[-1]}², f32, B={MAIN_B}): {ms:.3f} ms "
            f"(the mass-matrix FD's last step alone; no PyTorch call "
            f"computes the free-flyer FD); card {name_limit}")
        del M, rhs
    return times


# ---------------------------------------------------------------- phase S
@functools.lru_cache(maxsize=None)
def stance_height(label):
    """The base height of phase S's states: the bench's 0.5 m where
    STEP_DEPTH is None (HyQ), else the height that puts the lowest foot
    STEP_DEPTH into the ground at the identity attitude and the zero
    posture — computed on the CPU, so that the counting child
    (count_ops_child) draws the states this process draws."""
    depth = STEP_DEPTH[label]
    if depth is None:
        return 0.5
    m = ff_model(label, torch.float64, device="cpu")
    one = torch.ones((1, 1), dtype=torch.float64)
    quat = torch.cat([one, 0 * one, 0 * one, 0 * one])
    q = torch.zeros((m.n, 1), dtype=torch.float64)
    gaps, _ = step_feet(m, quat, 0 * quat[:3], q, label, None)
    return float(-gaps.min()) - depth


def step_states(m, B, gen, label, device="cuda"):
    """bench_contact.py's stepper states, batch first: the identity
    attitude, pos (0, 0, stance_height), the joints at the robot's posture
    ± 0.05, vb and q̇ ± 0.3, τ ± 10 → ((quat, pos, q, vb, qd), tau)."""
    _, _, _, posture, _ = FF_ROBOTS[label]

    def uni(d, r):
        return (torch.rand((B, d), generator=gen, device=device,
                           dtype=m.dtype) * (2 * r) - r)
    quat = torch.zeros((B, 4), dtype=m.dtype, device=device)
    quat[:, 0] = 1.0
    pos = torch.zeros((B, 3), dtype=m.dtype, device=device)
    pos[:, 2] = stance_height(label)
    mean = torch.tensor(posture, dtype=m.dtype, device=device).repeat(
        m.n // len(posture))
    q = mean + uni(m.n, STEP_POSTURE_SPREAD)
    return (quat, pos, q, uni(6, 0.3), uni(m.n, 0.3)), uni(m.n, 10.0)


def step_api(label, grid):
    """Phase S's call of a cell: the public entry on batch-first states,
    μ = 0.8, 30 sweeps (bench_contact.py), on the flat ground or a grid."""
    links, off, _ = ff_geometry(label)
    terr = step_terrain(grid, torch.float32)

    def fb_step_ground_batched(m, state, tau):
        return tct.fb_step_ground_batched(m, state, tau, STEP_DT, links, off,
                                          mu=STEP_MU, iters=STEP_ITERS,
                                          terrain=terr)
    return fb_step_ground_batched


def hyq_rollout(state, tau):
    """HyQ's rollout (bench_contact.py's): the call, the first ROLLOUT_B
    states and their τ held over ROLLOUT_T steps."""
    links, off, _ = ff_geometry("hyq")

    def fb_simulate_ground_batched(m, state, taus):
        return tct.fb_simulate_ground_batched(m, state, taus, STEP_DT, links,
                                              off, mu=STEP_MU,
                                              iters=STEP_ITERS)
    return (fb_simulate_ground_batched, tuple(x[:ROLLOUT_B] for x in state),
            tau[:ROLLOUT_B][None].expand(ROLLOUT_T, -1, -1))


def step_cols(m, state, tau, label, k=None):
    """The first ``k`` of batch-first states as the step kernel's
    batch-last arguments, μ = STEP_MU."""
    cols = [x[:k].T.contiguous() for x in (*state, tau)]
    mu = torch.full((len(FF_ROBOTS[label][1]), cols[0].shape[-1]), STEP_MU,
                    dtype=m.dtype, device=cols[0].device)
    return cols + [mu]


def step_frame(m, label):
    """ptxas's line for the float32 step kernels of ``label``'s feet."""
    return lib_frame(m, FF_ROBOTS[label][1], "ff.cu", "step_ground")


def step_invariants(gen):
    """Float64 checks on STEP_INV_STATES random states of each free flyer
    (phase 1's, random attitudes: feet in and out of contact), flat and on
    the 121² grid, that do not go through the plain version: a unit
    quaternion, pn ≥ 0 and 0 where a foot is inactive, ‖pt‖ ≤ μ·pn, and a
    rollout of STEP_INV_T steps equal to as many single steps, bit for
    bit."""
    for label in FF_CHECK:
        m = ff_model(label, torch.float64)
        s = ff_states(m, STEP_INV_STATES, gen, label)
        mu = step_inputs(m, STEP_INV_STATES, gen, label, False)[0]
        links, off, _ = ff_geometry(label)
        for grid in (None, "121"):
            kern, _ = step_fns(label, grid, False, torch.float64)
            out = kern(m, *s, mu)
            _, gaps = step_switches(m, s, label, grid)
            active = gaps < STEP_MARGIN
            imp = out[5]
            pn = imp[2::3]
            pt = torch.sqrt(imp[0::3] ** 2 + imp[1::3] ** 2)
            quat_err = float((torch.linalg.vector_norm(out[0], dim=0)
                              - 1).abs().max())
            cone = float((pt - mu * pn).max())
            ok = (quat_err <= QUAT_TOL and float(pn.min()) >= 0.0
                  and not bool(pn[~active].any()) and cone <= CONE_TOL)
            tag = (f"phaseS invariants {label} {grid or 'flat'} (f64, "
                   f"{STEP_INV_STATES} states, {float(active.double().mean()):.1%}"
                   f" of feet active)")
            log(f"{tag}: |‖quat⁺‖ − 1| {quat_err:.2e} (bound {QUAT_TOL:.0e}),"
                f" min pn {float(pn.min()):.3e}, max pn where inactive "
                f"{float(pn[~active].abs().max()) if (~active).any() else 0.0:.1e}"
                f", max ‖pt‖ − μ·pn {cone:.3e} (bound {CONE_TOL:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{tag}: an invariant fails")
            # a rollout against single steps, batch first
            state = tuple(x.T for x in s[:5])
            taus = torch.rand((STEP_INV_T,) + tuple(s[5].T.shape),
                              generator=gen, device="cuda",
                              dtype=m.dtype) * 20 - 10
            terr = step_terrain(grid, torch.float64)
            kw = dict(mu=mu.T, iters=STEP_ITERS, terrain=terr)
            final, imps = tct.fb_simulate_ground_batched(
                m, state, taus, STEP_DT, links, off, **kw)
            same = True
            for t in range(STEP_INV_T):
                state, imp1 = tct.fb_step_ground_batched(
                    m, state, taus[t], STEP_DT, links, off, **kw)
                same &= torch.equal(imp1, imps[t])
            same &= all(torch.equal(a, b) for a, b in zip(state, final))
            log(f"{tag}: a {STEP_INV_T}-step rollout equals "
                f"{STEP_INV_T} single steps bit for bit: {same}")
            if not same:
                raise RuntimeError(f"{tag}: the rollout differs from its "
                                   f"steps")


def phaseS_ground_step(gen):
    """The frictional ground step through ``fb_step_ground_batched`` at
    B = 2¹⁸, float32, in each cell of STEP_PATHS: the counts set to 0 just
    before the call and read just after (exactly one launch of its
    kernel), its peak memory, the outputs' shapes, a 256-state head of
    each output against the plain version (the float32 rule, away from a
    switch), the share of active feet; then HyQ's rollout of ROLLOUT_T
    steps at ROLLOUT_B (``fb_simulate_ground_batched``, one launch a step)
    against as many single API steps, bit for bit; then the float64
    invariants (step_invariants)."""
    launches, max_abs, models, states = {}, {}, {}, {}
    for cell, (label, grid) in STEP_PATHS.items():
        if label not in models:
            models[label] = ff_model(label)
            states[label] = step_states(models[label], MAIN_B, gen, label)
        m, (state, tau) = models[label], states[label]
        fn = step_api(label, grid)
        key = "step_ground" if grid is None else "step_ground_terrain"
        k = len(FF_ROBOTS[label][1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _launch.reset_launches()
        t0 = time.perf_counter()
        nxt, imp = fn(m, state, tau)
        torch.cuda.synchronize()
        got = dict(_launch.LAUNCHES)
        made = {k_: v for k_, v in got.items() if v}
        tag = f"phaseS {cell} (n={m.n}, {k} feet)"
        log(f"{tag} B={MAIN_B} (first call): "
            f"{time.perf_counter() - t0:.3f} s; launches {made}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
        if made != {key: 1}:
            raise RuntimeError(f"{tag}: launched {made}, not {{{key}: 1}}")
        launches[cell] = got
        for o, shape in zip((*nxt, imp), [(MAIN_B, d) for d in
                                          (4, 3, m.n, 6, m.n)]
                            + [(MAIN_B, k, 3)]):
            if o.device.type != "cuda" or tuple(o.shape) != shape:
                raise RuntimeError(f"{tag}: {o.device} {tuple(o.shape)}")
        check_finite(tag, (*nxt, imp))
        cols = step_cols(m, state, tau, label, PARITY_STATES)
        head = (*(o[:PARITY_STATES].T for o in nxt),
                imp[:PARITY_STATES].reshape(PARITY_STATES, 3 * k).T)
        keep, _ = step_switches(m, cols, label, grid)
        _, plain = step_fns(label, grid, False, m.dtype)
        max_abs[cell], _ = check_against_plain(
            f"{tag} API vs plain ({PARITY_STATES} states)", head, plain, m,
            cols, keep)
        _, gaps = step_switches(m, step_cols(m, state, tau, label,
                                             STEP_INV_STATES), label, grid)
        log(f"{tag}: {float((gaps < STEP_MARGIN).double().mean()):.1%} of "
            f"the feet active ({STEP_INV_STATES} states), "
            f"{float((imp[..., 2] > 0).double().mean()):.1%} carrying a "
            f"normal impulse (all states)")
        del nxt, imp

    # HyQ's rollout: one launch a step, equal to single API steps
    m = models["hyq"]
    roll, sub, taus = hyq_rollout(*states["hyq"])
    torch.cuda.synchronize()
    _launch.reset_launches()
    t0 = time.perf_counter()
    final, imps = roll(m, sub, taus)
    torch.cuda.synchronize()
    got = dict(_launch.LAUNCHES)
    made = {k_: v for k_, v in got.items() if v}
    tag = f"phaseS hyq rollout T={ROLLOUT_T} B={ROLLOUT_B}"
    log(f"{tag} (first call): {time.perf_counter() - t0:.3f} s; launches "
        f"{made}")
    if made != {"step_ground": ROLLOUT_T}:
        raise RuntimeError(f"{tag}: launched {made}")
    launches["hyq_rollout"] = got
    fn = step_api("hyq", None)
    s, same = sub, True
    for t in range(ROLLOUT_T):
        s, imp = fn(m, s, taus[t])
        same &= torch.equal(imp, imps[t])
    same &= all(torch.equal(a, b) for a, b in zip(s, final))
    log(f"{tag}: equals {ROLLOUT_T} single API steps bit for bit: {same}")
    if not same:
        raise RuntimeError(f"{tag}: the rollout differs from its steps")
    del final, imps, s
    step_invariants(gen)
    return launches, max_abs, models, states


# JSON name → phase-S cell: where each step kernel is timed
STEP_TIMED = {"step_ground": "hyq", "step_ground_terrain": "hyq_terrain",
              "step_ground[atlas]": "atlas"}


def _step_cpu_states(label):
    """make_args for ops_per_state of a step kernel: CPU states drawn as
    phase S's, from SEED."""
    def make(mc, B):
        gen = torch.Generator().manual_seed(SEED)
        state, tau = step_states(mc, B, gen, label, device="cpu")
        return step_cols(mc, state, tau, label)
    return make


def phase3_ground_step(models, states):
    """Times of the step kernels and their plain version at phase S's
    shapes, their bounds (the operations averaged over STEP_OPS_STATES
    states drawn like the timed ones, beside the share of active feet
    there; bytes with the height grid read once), the API times and
    env-steps/s, HyQ's rollout, the ptxas frames, and profiler breakdowns
    of HyQ's two cells (in a child process). No PyTorch call computes a
    PGS step: no library time."""
    name_limit = card()
    times = {}
    for name, cell in STEP_TIMED.items():
        label, grid = STEP_PATHS[cell]
        m, (state, tau) = models[label], states[label]
        kern, plain = step_fns(label, grid, False, m.dtype)
        cols = step_cols(m, state, tau, label)
        terr = step_terrain(grid, m.dtype)
        make = _step_cpu_states(label)
        mc = m.to(device="cpu", dtype=torch.float64)
        _, gaps = step_switches(mc, make(mc, STEP_OPS_STATES), label, grid)
        log(f"phase3 {name}: the bound's {STEP_OPS_STATES} CPU states have "
            f"{float((gaps < STEP_MARGIN).double().mean()):.1%} of their feet"
            f" active; {STEP_ITERS} sweeps")
        times[name] = time_entry(
            cell, name, kern, plain, m, cols, name_limit,
            const_bytes=0 if terr is None else nbytes(terr.heights))
        api = time_ms(step_api(label, grid), (m, state, tau))
        log(f"phase3 fb_step_ground_batched API {cell} B={MAIN_B}: "
            f"{api:.3f} ms (median of {TIMED_CALLS}; {MAIN_B / api * 1e3:.3e}"
            f" env-steps/s; kernel {times[name]['ms']:.3f} ms, 1 launch a "
            f"call); frame {step_frame(m, label)}; card {name_limit}")
        del cols
    roll, sub, taus = hyq_rollout(*states["hyq"])
    ms = time_ms(roll, (models["hyq"], sub, taus), calls=5)
    log(f"phase3 fb_simulate_ground_batched API hyq T={ROLLOUT_T} "
        f"B={ROLLOUT_B}: {ms:.3f} ms (median of 5; "
        f"{ROLLOUT_T * ROLLOUT_B / ms * 1e3:.3e} env-steps/s); card "
        f"{name_limit}")
    step_profile()
    return times


def step_profile():
    """Profiler breakdowns of the free-flyer kernels, HyQ's flat and
    heightfield steps, HyQ's step with ground geoms and the ball ant's md
    step at MAIN_B, in one child process (step_profile_child; see
    md_profile)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--step-profile"],
        capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        raise RuntimeError(f"profile child failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")


def step_profile_child():
    """step_profile's child (``--step-profile``): profiler breakdowns of
    HyQ's stance FD and Atlas's ABA, HyQ's flat and heightfield steps, the
    ball ant's md step, HyQ's step with ground geoms and the two cells of
    ROWS_PATHS (collision, loops), all at MAIN_B."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    name_limit = card()
    for label, entry in (("hyq", "stance"), ("atlas", "aba")):
        m = ff_model(label)
        fn, _, kname = ff_entries(label)[entry]
        s = ff_args(ff_states(m, MAIN_B, gen, label, layout="Bd"),
                    ff_pairs(label)[kname][3])
        profile_breakdown(fn, (m, *s), f"{fn.__name__} free {label} (a "
                          f"fresh process)", name_limit)
    m = ff_model("hyq")
    state, tau = step_states(m, MAIN_B, gen, "hyq")
    for cell in ("hyq", "hyq_terrain"):
        fn = step_api(*STEP_PATHS[cell])
        profile_breakdown(fn, (m, state, tau), f"{fn.__name__} {cell} (a "
                          f"fresh process)", name_limit)
    profile_breakdown(geoms_api, (m, *step_states(m, MAIN_B, gen, "hyq")),
                      "fb_step_ground_batched hyq_geoms (a fresh process)",
                      name_limit)
    m = md_step_model("ball_ant")
    fn = md_api(m)
    profile_breakdown(fn, (m, *md_step_states(m, MAIN_B, gen)),
                      f"{fn.__name__} ball_ant (a fresh process)",
                      name_limit)
    for case in ROWS_PATHS:
        m = ff_model(ROWS_CASES[case][0])
        fn = rows_api(case)
        profile_breakdown(fn, (m, *rows_path_states(m, MAIN_B, gen, case)),
                          f"{fn.__name__} {case} (a fresh process)",
                          name_limit)


# ------------------------------------------ phase S: md step, ground geoms
def md_api(m, torso=True, **kw):
    """Phase S's md call: md_step_ground_batched on batch-first states,
    μ MD_STEP_MU, the torso sphere with STEP_MU_GROUND, STEP_ITERS
    sweeps (bench_contact.py:270-274)."""
    feet, offs, _ = md_step_contacts("ball_ant", torso)

    def md_step_ground_batched(m, q, qd, tau):
        return gt.md_step_ground_batched(
            m, q, qd, tau, MD_STEP_DT, feet, offs, mu=MD_STEP_MU,
            iters=STEP_ITERS, ground_geoms=md_torso(m.dtype, m.device.type)
            if torso else None, mu_ground=STEP_MU_GROUND, **kw)
    return md_step_ground_batched


def geoms_api(m, state, tau):
    """Phase S's ground-geom cell (bench_contact.py:236-240): HyQ's feet and
    geoms, μ STEP_MU, μ_ground STEP_MU_GROUND."""
    links, off, _ = ff_geometry("hyq")
    return tct.fb_step_ground_batched(
        m, state, tau, STEP_DT, links, off, mu=STEP_MU, iters=STEP_ITERS,
        ground_geoms=step_geoms(m.dtype), mu_ground=STEP_MU_GROUND)


def geoms_cols(m, state, tau, k=None):
    """The first ``k`` HyQ states as the step kernel's batch-last
    arguments, μ STEP_MU on the feet and STEP_MU_GROUND on the geoms."""
    cols = [x[:k].T.contiguous() for x in (*state, tau)]
    B = cols[0].shape[-1]
    kf = len(FF_ROBOTS["hyq"][1])
    mu = torch.cat([torch.full((kf, B), STEP_MU, dtype=m.dtype,
                               device=cols[0].device),
                    torch.full((step_contacts("hyq", True) - kf, B),
                               STEP_MU_GROUND, dtype=m.dtype,
                               device=cols[0].device)])
    return cols + [mu]


def md_cols(m, q, qd, tau, k=None):
    """The first ``k`` md states as the kernel's batch-last arguments, μ
    MD_STEP_MU on the feet and STEP_MU_GROUND on the torso."""
    cols = [x[:k].T.contiguous() for x in (q, qd, tau)]
    B = cols[0].shape[-1]
    mu = torch.tensor([MD_STEP_MU] * 4 + [STEP_MU_GROUND], dtype=m.dtype,
                      device=cols[0].device)[:, None].expand(5, B)
    return cols + [mu.contiguous()]


def _first_call(tag, fn, args, expect):
    """Run a phase-S call with the counts set to 0 just before it; it must
    make exactly the launches ``expect``. → (outputs, the counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    got = dict(_launch.LAUNCHES)
    made = {k_: v for k_, v in got.items() if v}
    log(f"{tag} B={MAIN_B} (first call): {time.perf_counter() - t0:.3f} s;"
        f" launches {made}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    if made != expect:
        raise RuntimeError(f"{tag}: launched {made}, not {expect}")
    return out, got


def md_invariants(gen):
    """Float64 checks on STEP_INV_STATES ball-ant states through the entry
    with the torso sphere and the knees' projected limits, that do not go
    through the plain version: every quaternion of q⁺ (the free joint's
    and the four ball hips') unit to QUAT_TOL, pn ≥ 0 and 0 where a
    contact is inactive, ‖pt‖ ≤ μ·pn + CONE_TOL with each contact's own μ
    (the torso's STEP_MU_GROUND), and the knees inside their limits."""
    m = md_step_model("ball_ant", torch.float64)
    q, qd, tau = md_step_states(m, STEP_INV_STATES, gen)
    lo, hi = md_knee_limits(m)
    (q2, v2), imp = md_api(m, limits=(lo, hi))(m, q, qd, tau)
    gaps = md_step_gaps(m, q.T.contiguous(), "ball_ant", True)
    active = (gaps < STEP_MARGIN).T                       # (B, 5)
    quat_err = max(float((torch.linalg.vector_norm(q2[:, s:s + 4], dim=1)
                          - 1).abs().max())
                   for (s, w) in m.q_slices if w == 4 or w == 7)
    mu = torch.tensor([MD_STEP_MU] * 4 + [STEP_MU_GROUND],
                      dtype=torch.float64, device="cuda")
    pn = imp[..., 2]
    cone = float((torch.sqrt(imp[..., 0] ** 2 + imp[..., 1] ** 2)
                  - mu * pn).max())
    knees = [s for (s, w), t in zip(m.q_slices, m.joint_types)
             if t == "revolute"]
    inside = bool(((q2[:, knees] >= MD_KNEE_LIMITS[0])
                   & (q2[:, knees] <= MD_KNEE_LIMITS[1])).all())
    ok = (quat_err <= QUAT_TOL and float(pn.min()) >= 0.0
          and not bool(pn[~active].any()) and cone <= CONE_TOL and inside)
    tag = (f"phaseS md invariants ball_ant (f64, {STEP_INV_STATES} states, "
           f"{float(active.double().mean()):.1%} of contacts active)")
    log(f"{tag}: |‖quat⁺‖ − 1| {quat_err:.2e} over the free joint and four "
        f"ball hips (bound {QUAT_TOL:.0e}), min pn {float(pn.min()):.3e}, "
        f"pn where inactive "
        f"{float(pn[~active].abs().max()) if (~active).any() else 0.0:.1e}, "
        f"max ‖pt‖ − μ·pn {cone:.3e} (bound {CONE_TOL:.0e}), knees inside "
        f"{MD_KNEE_LIMITS}: {inside} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{tag}: an invariant fails")


def phaseS_md_and_geoms(gen):
    """The multi-dof step through ``md_step_ground_batched`` on the ball ant
    (feet and torso sphere) and HyQ's step with its ground geoms through
    ``fb_step_ground_batched``, B = 2¹⁸, float32, bench_contact.py's
    states: one launch a call, shapes, a 256-state head against the plain
    version (the float32 rule, away from a switch), the share of active
    contacts; then the md float64 invariants (md_invariants)."""
    launches, max_abs, models, states = {}, {}, {}, {}
    m = md_step_model("ball_ant")
    q, qd, tau = md_step_states(m, MAIN_B, gen)
    models["md"], states["md"] = m, (q, qd, tau)
    tag = f"phaseS md_ball_ant (nq={m.nq}, nv={m.nv}, 5 contacts)"
    ((q2, v2), imp), launches["md_ball_ant"] = _first_call(
        tag, md_api(m), (m, q, qd, tau), {"md_step_ground": 1})
    for o, shape in zip((q2, v2, imp), ((MAIN_B, m.nq), (MAIN_B, m.nv),
                                        (MAIN_B, 5, 3))):
        if o.device.type != "cuda" or tuple(o.shape) != shape:
            raise RuntimeError(f"{tag}: {o.device} {tuple(o.shape)}")
    check_finite(tag, (q2, v2, imp))
    cols = md_cols(m, q, qd, tau, PARITY_STATES)
    _, plain = md_step_fns("ball_ant", True, False, m.dtype)
    head = (q2[:PARITY_STATES].T, v2[:PARITY_STATES].T,
            imp[:PARITY_STATES].reshape(PARITY_STATES, 15).T)
    max_abs["md_ball_ant"], _ = check_against_plain(
        f"{tag} API vs plain ({PARITY_STATES} states)", head, plain, m, cols,
        md_step_keep(m, cols[0], "ball_ant", True))
    gaps = md_step_gaps(m, q[:STEP_INV_STATES].T.contiguous(), "ball_ant",
                        True)
    log(f"{tag}: {float((gaps < STEP_MARGIN).double().mean()):.1%} of the "
        f"contacts active ({STEP_INV_STATES} states), "
        f"{float((imp[..., 2] > 0).double().mean()):.1%} carrying a normal "
        f"impulse (all states)")
    del q2, v2, imp

    m = ff_model("hyq")
    state, tau = step_states(m, MAIN_B, gen, "hyq")
    models["hyq_geoms"], states["hyq_geoms"] = m, (state, tau)
    k = step_contacts("hyq", True)
    tag = f"phaseS hyq_geoms (n={m.n}, {k} contacts)"
    (nxt, imp), launches["hyq_geoms"] = _first_call(
        tag, geoms_api, (m, state, tau), {"step_ground": 1})
    for o, shape in zip((*nxt, imp), [(MAIN_B, d) for d in
                                      (4, 3, m.n, 6, m.n)] + [(MAIN_B, k, 3)]):
        if o.device.type != "cuda" or tuple(o.shape) != shape:
            raise RuntimeError(f"{tag}: {o.device} {tuple(o.shape)}")
    check_finite(tag, (*nxt, imp))
    cols = geoms_cols(m, state, tau, PARITY_STATES)
    head = (*(o[:PARITY_STATES].T for o in nxt),
            imp[:PARITY_STATES].reshape(PARITY_STATES, 3 * k).T)
    keep, _ = step_switches(m, cols, "hyq", None, geoms=True)
    _, plain = step_fns("hyq", None, False, m.dtype, geoms=True)
    max_abs["hyq_geoms"], _ = check_against_plain(
        f"{tag} API vs plain ({PARITY_STATES} states)", head, plain, m, cols,
        keep, sensitive=True)
    _, gaps = step_switches(m, geoms_cols(m, state, tau, STEP_INV_STATES),
                            "hyq", None, geoms=True)
    log(f"{tag}: {float((gaps < STEP_MARGIN).double().mean()):.1%} of the "
        f"contacts active ({STEP_INV_STATES} states; feet "
        f"{float((gaps[:4] < STEP_MARGIN).double().mean()):.1%}, geoms "
        f"{float((gaps[4:] < STEP_MARGIN).double().mean()):.1%}), "
        f"{float((imp[..., 2] > 0).double().mean()):.1%} carrying a normal "
        f"impulse (all states)")
    del nxt, imp
    md_invariants(gen)
    return launches, max_abs, models, states


def _md_cpu_step_states(mc, B):
    gen = torch.Generator().manual_seed(SEED)
    q, qd, tau = md_step_states(mc, B, gen, device="cpu")
    return md_cols(mc, q, qd, tau)


def _geoms_cpu_states(mc, B):
    gen = torch.Generator().manual_seed(SEED)
    state, tau = step_states(mc, B, gen, "hyq", device="cpu")
    return geoms_cols(mc, state, tau)


def lib_frame(m, links, unit, name, pairs=None):
    """ptxas's lines for the float32 kernel ``name`` of a library."""
    lib = _build.library(m, None, links, pairs)
    return [ln.strip() for ln in ptxas_report(lib.logs[unit])
            if f"{name}<float" in ln]


def phase3_md_and_geoms(models, states):
    """Times of the md step kernel and the step kernel with ground geoms
    and their plain versions at phase S's shapes, their bounds (the
    operations averaged over STEP_OPS_STATES CPU states drawn like the
    timed ones, beside the share of active contacts there), the API times
    and env-steps/s, the ptxas frames, and profiler breakdowns of both
    calls (printed by phase 3 ground step's child process, step_profile).
    No PyTorch call computes a PGS step: no library time."""
    name_limit = card()
    times = {}
    m = models["md"]
    q, qd, tau = states["md"]
    kern, plain = md_step_fns("ball_ant", True, False, m.dtype)
    mc = m.to(device="cpu", dtype=torch.float64)
    gaps = md_step_gaps(mc, _md_cpu_step_states(mc, STEP_OPS_STATES)[0],
                        "ball_ant", True)
    log(f"phase3 md_step_ground: the bound's {STEP_OPS_STATES} CPU states "
        f"have {float((gaps < STEP_MARGIN).double().mean()):.1%} of their "
        f"contacts active; {STEP_ITERS} sweeps")
    times["md_step_ground"] = time_entry(
        "md_ball_ant", "md_step_ground", kern, plain, m,
        md_cols(m, q, qd, tau), name_limit)
    api = time_ms(md_api(m), (m, q, qd, tau))
    feet = md_step_contacts("ball_ant", True)[0]
    log(f"phase3 md_step_ground_batched API ball_ant B={MAIN_B}: {api:.3f} "
        f"ms (median of {TIMED_CALLS}; {MAIN_B / api * 1e3:.3e} env-steps/s;"
        f" kernel {times['md_step_ground']['ms']:.3f} ms, 1 launch a call); "
        f"frame {lib_frame(m, feet + (0,), 'md_step.cu', 'md_step_ground')};"
        f" card {name_limit}")

    m = models["hyq_geoms"]
    state, tau = states["hyq_geoms"]
    kern, plain = step_fns("hyq", None, False, m.dtype, geoms=True)
    mc = m.to(device="cpu", dtype=torch.float64)
    _, gaps = step_switches(mc, _geoms_cpu_states(mc, STEP_OPS_STATES),
                            "hyq", None, geoms=True)
    log(f"phase3 step_ground[hyq_geoms]: the bound's {STEP_OPS_STATES} CPU "
        f"states have {float((gaps < STEP_MARGIN).double().mean()):.1%} of "
        f"their contacts active; {STEP_ITERS} sweeps")
    times["step_ground[hyq_geoms]"] = time_entry(
        "hyq_geoms", "step_ground[hyq_geoms]", kern, plain, m,
        geoms_cols(m, state, tau), name_limit)
    api = time_ms(geoms_api, (m, state, tau))
    links = FF_ROBOTS["hyq"][1] + cff.geom_links(
        cff.ground_geoms_static(step_geoms(m.dtype)))
    log(f"phase3 fb_step_ground_batched API hyq_geoms B={MAIN_B}: "
        f"{api:.3f} ms (median of {TIMED_CALLS}; "
        f"{MAIN_B / api * 1e3:.3e} env-steps/s; kernel "
        f"{times['step_ground[hyq_geoms]']['ms']:.3f} ms, 1 launch a call); "
        f"frame {lib_frame(m, links, 'ff.cu', 'step_ground')}; card "
        f"{name_limit}")
    return times


# ------------------------------------------ collision and loop-closure rows
def phase1_rows(gen):
    """The step kernels with collision contacts and loop closures against
    their plain versions at B = 1000, float64 (but where STEP_F32_ONLY
    leaves them out) and float32, in each case of
    ROWS_PHASE1: HyQ with the fat collision set (self and obstacle pairs),
    with HyQ's ground geoms too (24 contacts, 72 rows), with a push, a soft
    contact and restitution; the 3-link chain's base capsule in a self
    pair; the four-bar's closure and a world pin, flat and on the 121²
    grid. Every case holds its round-off-sensitive states (the segments'
    kinks, the frame's flip at n_z = 0, near-duplicate contacts) one by
    one (check_against_plain's ``sensitive``); float32 leaves out the
    states within STEP_SWITCH of a switch."""
    for case in ROWS_PHASE1:
        label = ROWS_CASES[case][0]
        for dtype in (torch.float64, torch.float32):
            m = ff_model(label, dtype)
            s = rows_states(m, PHASE1_B, gen, label)
            kern, plain, key = rows_fns(case, dtype)
            kf, kc, kg = rows_counts(case)
            if dtype == torch.float64 and case in STEP_F32_ONLY:
                rows_inputs(m, PHASE1_B, gen, case)
                continue
            keep = (None if dtype == torch.float64
                    else rows_switches(m, s, case)[0])
            run_pair(f"phase1 rows {case} {str(dtype)[6:]} B={PHASE1_B} "
                     f"({kf} feet, {kc} collision, {kg} geom contacts, "
                     f"{ROWS_CASES[case][3] or 'no'} loops)", key, kern,
                     plain, m, (*s, *rows_inputs(m, PHASE1_B, gen, case)),
                     keep, sensitive=True)


def rows_api(case):
    """Phase S's call of a ROWS_PATHS cell: the public entry on batch-first
    states, μ STEP_MU (the collision contacts' COLL_MU), STEP_ITERS
    sweeps."""
    label, cset, _, lset, _, _ = ROWS_CASES[case]
    links, off, _ = ff_geometry(label)

    def fb_step_ground_batched(m, state, tau):
        return tct.fb_step_ground_batched(
            m, state, tau, STEP_DT, links, off, mu=STEP_MU, iters=STEP_ITERS,
            collision=coll_model(cset, label, m.dtype, m.device.type),
            mu_collision=COLL_MU,
            loops=None if lset is None else LOOP_SETS[lset])
    return fb_step_ground_batched


def rows_cols(m, state, tau, case, k=None):
    """The first ``k`` batch-first states of a cell as the step kernel's
    batch-last arguments, μ as rows_api's."""
    cols = [x[:k].T.contiguous() for x in (*state, tau)]
    kf, kc, kg = rows_counts(case)
    B = cols[0].shape[-1]
    mu = torch.cat([torch.full((kf, B), STEP_MU, dtype=m.dtype,
                               device=cols[0].device),
                    torch.full((kc, B), COLL_MU, dtype=m.dtype,
                               device=cols[0].device)])
    return cols + [mu]


def rows_path_states(m, B, gen, case, device="cuda"):
    """A cell's bench states, batch first: HyQ's bench_contact.py states,
    the four-bar's bench_loops.py states → ((quat, pos, q, vb, qd), tau)."""
    label = ROWS_CASES[case][0]
    if label == "four_bar":
        s = loop_states(m, B, gen, device, layout="Bd")
        return tuple(s[:5]), s[5]
    return step_states(m, B, gen, label, device)


def rows_invariants(gen):
    """Float64 checks of both cells on STEP_INV_STATES random states
    (rows_states), through the entry: unit quaternions, pn ≥ 0 and 0 where
    a contact is inactive, ‖pt‖ ≤ μ·pn + CONE_TOL with each contact's μ;
    then the four-bar's rollout of LOOP_ROLLOUT_T steps from closed
    configurations keeps its closure gap (fb_loop_gap) within
    LOOP_GAP_FACTOR × the plain version's on the same states."""
    for case in ROWS_PATHS:
        label, cset, _, lset, _, _ = ROWS_CASES[case]
        m = ff_model(label, torch.float64)
        s = rows_states(m, STEP_INV_STATES, gen, label, layout="Bd")
        nxt, imp = rows_api(case)(m, tuple(s[:5]), s[5])
        _, gaps = step_switches(m, [x.T for x in s], label, None,
                                cset=cset)
        active = (gaps < STEP_MARGIN).T                       # (B, k_t)
        kf, kc, _ = rows_counts(case)
        mu = torch.tensor([STEP_MU] * kf + [COLL_MU] * kc,
                          dtype=torch.float64, device="cuda")
        pn = imp[..., 2]
        cone = float((torch.sqrt(imp[..., 0] ** 2 + imp[..., 1] ** 2)
                      - mu * pn).max())
        quat_err = float((torch.linalg.vector_norm(nxt[0], dim=1)
                          - 1).abs().max())
        ok = (quat_err <= QUAT_TOL and float(pn.min()) >= 0.0
              and not bool(pn[~active].any()) and cone <= CONE_TOL)
        tag = (f"phaseS invariants {case} (f64, {STEP_INV_STATES} states, "
               f"{float(active.double().mean()):.1%} of contacts active"
               + (f", collision {float(active[:, kf:].double().mean()):.1%}"
                  if kc else "") + ")")
        log(f"{tag}: |‖quat⁺‖ − 1| {quat_err:.2e} (bound {QUAT_TOL:.0e}), "
            f"min pn {float(pn.min()):.3e}, pn where inactive "
            f"{float(pn[~active].abs().max()) if (~active).any() else 0.0:.1e}"
            f", max ‖pt‖ − μ·pn {cone:.3e} (bound {CONE_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{tag}: an invariant fails")
    # the closure over a rollout, kernel against plain
    case = "loop_ground_step_four_bar"
    label, _, _, lset, _, _ = ROWS_CASES[case]
    loops = LOOP_SETS[lset]
    m = ff_model(label, torch.float64)
    s = loop_states(m, STEP_INV_STATES, gen, layout="Bd", closed=True)
    links, off, _ = ff_geometry(label)
    taus = s[5][None].expand(LOOP_ROLLOUT_T, -1, -1)
    gap0 = float(gt.fb_loop_gap(m, s[0].T, s[1].T, s[2].T, *loops).abs()
                 .max())
    final, _ = tct.fb_simulate_ground_batched(
        m, tuple(s[:5]), taus, STEP_DT, links, off, mu=STEP_MU,
        iters=STEP_ITERS, loops=loops)
    _, plain, _ = rows_fns(case, torch.float64)
    p = [x.T.contiguous() for x in s[:5]]
    mu = torch.full((len(links), STEP_INV_STATES), STEP_MU,
                    dtype=torch.float64, device="cuda")
    for _ in range(LOOP_ROLLOUT_T):
        p = list(plain(m, *p, s[5].T.contiguous(), mu)[:5])
    gk = gt.fb_loop_gap(m, *(x.T for x in final[:3]), *loops).abs()
    gp = gt.fb_loop_gap(m, *p[:3], *loops).abs()
    g_k, g_p = float(gk.max()), float(gp.max())
    ok = g_k <= LOOP_GAP_FACTOR * g_p
    tag = (f"phaseS closure {case} (f64, {STEP_INV_STATES} closed states, "
           f"T={LOOP_ROLLOUT_T})")
    log(f"{tag}: max closure gap {g_k:.3e} m (plain {g_p:.3e}, bound "
        f"{LOOP_GAP_FACTOR:g}x it; median {float(gk.amax(0).median()):.1e}"
        f", plain {float(gp.amax(0).median()):.1e}; at t=0 {gap0:.1e}; the "
        f"bench's states put feet up to 0.5 m into the ground, and erp "
        f"lifts them at up to 100 m/s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{tag}: the kernel's closure drifts")


def phaseS_rows(gen):
    """The collision and loop cells through ``fb_step_ground_batched`` at
    B = 2¹⁸, float32: collision_step_hyq (bench_contact.py:190-220) and
    loop_ground_step_four_bar (bench_loops.py:84-115) — one launch a call,
    shapes, a 256-state head against the plain version (the float32 rule,
    away from a switch, sensitive states one by one), the share of active
    (collision) contacts; then the float64 invariants (rows_invariants)."""
    launches, max_abs, models, states = {}, {}, {}, {}
    for case in ROWS_PATHS:
        label, cset = ROWS_CASES[case][:2]
        m = ff_model(label)
        state, tau = rows_path_states(m, MAIN_B, gen, case)
        models[case], states[case] = m, (state, tau)
        kf, kc, _ = rows_counts(case)
        k = kf + kc
        tag = f"phaseS {case} (n={m.n}, {kf} feet + {kc} collision contacts)"
        (nxt, imp), launches[case] = _first_call(
            tag, rows_api(case), (m, state, tau), {"step_ground": 1})
        for o, shape in zip((*nxt, imp), [(MAIN_B, d) for d in
                                          (4, 3, m.n, 6, m.n)]
                            + [(MAIN_B, k, 3)]):
            if o.device.type != "cuda" or tuple(o.shape) != shape:
                raise RuntimeError(f"{tag}: {o.device} {tuple(o.shape)}")
        check_finite(tag, (*nxt, imp))
        cols = rows_cols(m, state, tau, case, PARITY_STATES)
        head = (*(o[:PARITY_STATES].T for o in nxt),
                imp[:PARITY_STATES].reshape(PARITY_STATES, 3 * k).T)
        keep, _ = step_switches(m, cols, label, None, cset=cset)
        _, plain, _ = rows_fns(case, m.dtype)
        max_abs[case], _ = check_against_plain(
            f"{tag} API vs plain ({PARITY_STATES} states)", head, plain, m,
            cols, keep, sensitive=True)
        _, gaps = step_switches(m, rows_cols(m, state, tau, case,
                                             STEP_INV_STATES), label, None,
                                cset=cset)
        act = gaps < STEP_MARGIN
        log(f"{tag}: {float(act.double().mean()):.1%} of the contacts "
            f"active ({STEP_INV_STATES} states; feet "
            f"{float(act[:kf].double().mean()):.1%}"
            + (f", collision {float(act[kf:].double().mean()):.1%}"
               if kc else "") + "), "
            f"{float((imp[..., 2] > 0).double().mean()):.1%} carrying a "
            f"normal impulse (all states)")
        del nxt, imp
    rows_invariants(gen)
    return launches, max_abs, models, states


def _rows_cpu_states(case):
    """make_args for ops_per_state of a cell: CPU states drawn as phase
    S's, from SEED."""
    def make(mc, B):
        gen = torch.Generator().manual_seed(SEED)
        state, tau = rows_path_states(mc, B, gen, case, device="cpu")
        return rows_cols(mc, state, tau, case)
    return make


def phase3_rows(models, states):
    """Times of the step kernel and its plain version in both collision and
    loop cells,
    their bounds (operations averaged over STEP_OPS_STATES CPU states drawn
    like the timed ones, beside the share of active contacts there), the
    API times and env-steps/s, the ptxas frames; the profiles come from
    the step profile's child (step_profile). No PyTorch call computes a
    PGS step: no library time."""
    name_limit = card()
    times = {}
    for case in ROWS_PATHS:
        label, cset = ROWS_CASES[case][:2]
        m, (state, tau) = models[case], states[case]
        kern, plain, _ = rows_fns(case, m.dtype)
        make = _rows_cpu_states(case)
        mc = m.to(device="cpu", dtype=torch.float64)
        _, gaps = step_switches(mc, make(mc, STEP_OPS_STATES), label, None,
                                cset=cset)
        log(f"phase3 step_ground[{case}]: the bound's {STEP_OPS_STATES} CPU "
            f"states have {float((gaps < STEP_MARGIN).double().mean()):.1%} "
            f"of their contacts active; {STEP_ITERS} sweeps")
        name = f"step_ground[{case}]"
        times[name] = time_entry(case, name, kern, plain, m,
                                 rows_cols(m, state, tau, case), name_limit)
        api = time_ms(rows_api(case), (m, state, tau))
        links, pairs = rows_key(case)
        log(f"phase3 fb_step_ground_batched API {case} B={MAIN_B}: "
            f"{api:.3f} ms (median of {TIMED_CALLS}; "
            f"{MAIN_B / api * 1e3:.3e} env-steps/s; kernel "
            f"{times[name]['ms']:.3f} ms, 1 launch a call); frame "
            f"{lib_frame(m, links, 'ff.cu', 'step_ground', pairs)}; card "
            f"{name_limit}")
    return times


# ------------------------------------------- phase V: the M⁻¹/FD variants
@contextmanager
def design(name):
    """K2′ and K5 on the CTA tiles ("tile", the route) or on the one-thread
    kernels they replaced ("thread")."""
    saved = _launch.DESIGN
    _launch.DESIGN = name
    try:
        yield
    finally:
        _launch.DESIGN = saved


TILE_PROBE_ROBOTS = ("branched_arm", "hyq", "atlas")
# the recursion ∇FD tile's robots (n ≤ MAX_KERNEL_JOINTS): a serial chain,
# siblings under a moving parent, and revolute and prismatic joints
FD_TILE_ROBOTS = {"iiwa14": ROBOTS["iiwa14"],
                  "branched_arm": ROBOTS["branched_arm"],
                  "chain5p": zoo.serial_chain(5, damping=0.1,
                                              prismatic_every=2)}
# the sweep tile's and the ∇FD tile's kernels, timed on both designs
SWEEP_TIMED = ("bias_and_v", "af", "af_bf16", "vaf")


def phase1_fd_tile(label, m, q, qd, u):
    """The recursion ∇FD tile against its plain version."""
    key, kern, plain, _ = PAIRS["fd_grad"]
    run_pair(f"phase1 {label} {str(m.dtype)[6:]} B={q.shape[-1]} tile "
             f"fd_grad", key, kern, plain, m, (q, qd, u))


def atlas_stages(m, q, qd, u):
    """Atlas's staged intermediates on the card's kernels (the inputs
    tile_pairs' kernels take)."""
    x = {}
    c, x["v"] = staged.bias_and_v_staged(m, q, qd)
    x["umc"] = u - c
    x["Minv"], x["qdd"] = staged.minv_qdd_dense_staged(m, q, x["umc"])
    x["a"], x["f"] = staged.af_staged(m, q, qd, x["qdd"], x["v"])
    x["v2"], x["a2"], x["f2"] = staged.vaf_staged(m, q, qd, u)
    x["v16"] = staged.to_stage(x["v"])
    return x


def tile_probe():
    """``chip_smoke.py --tile-probe``: the short first call for the tile
    kernels — build staged.cu for the branched arm, HyQ and Atlas and
    fused.cu for FD_TILE_ROBOTS, print ptxas's report, hold K5, K2′ and the
    sweep tile in every mode (tile_pairs) and the recursion ∇FD tile to
    their plain versions at PHASE1_B in float64 and float32, then time both
    designs (thread, tile, tile, thread): K5, K2′ and the sweeps at Atlas
    f32, 2¹⁸, and the ∇FD at iiwa-14."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    t0 = time.perf_counter()
    phase0_toolchain()
    urdf = {**ROBOTS, **ROUTE_ROBOTS}
    builds = [(label, gt.load_robot(urdf[label], device="cuda"), "staged.cu")
              for label in TILE_PROBE_ROBOTS]
    builds += [(label, gt.load_robot(u, device="cuda"), "fused.cu")
               for label, u in FD_TILE_ROBOTS.items()]
    threads = [threading.Thread(target=_build.library, args=(m, (unit,)))
               for _, m, unit in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for label, m, unit in builds:
        lib = _build.library(m, (unit,))
        log(f"build {label} (n={m.n}) {unit}: nvcc "
            f"{lib.build_seconds[unit]:.1f} s")
        for line in ptxas_report(lib.logs[unit]):
            log(line)
    log(f"-- probe builds done at {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for label, u in FD_TILE_ROBOTS.items():
        for dtype in (torch.float64, torch.float32):
            m = gt.load_robot(u, dtype=dtype, device="cuda")
            phase1_fd_tile(label, m,
                           *uniform_states(m.n, PHASE1_B, dtype, gen))
    for label in TILE_PROBE_ROBOTS:
        for dtype in (torch.float64, torch.float32):
            m = gt.load_robot(urdf[label], dtype=dtype, device="cuda")
            phase1_tiles(label, m,
                         *uniform_states(m.n, PHASE1_B, dtype, gen))
    log(f"-- probe checks done at {time.perf_counter() - t0:.1f} s")
    name_limit = card()

    def both(tag, fn, args):
        ms = {}
        for d in ("thread", "tile", "tile", "thread"):
            with design(d):
                ms.setdefault(d, []).append(time_ms(fn, args))
        log(f"probe {tag}: " + "; ".join(
            f"{d} {'/'.join(f'{t:.3f}' for t in v)} ms"
            for d, v in ms.items()) + f"; card {name_limit}")
    mI = [m for label, m, unit in builds if label == "iiwa14"][0]
    s = uniform_states(mI.n, MAIN_B, torch.float32, gen)
    both(f"iiwa14 f32 B={MAIN_B} fd_grad", fused.fd_grad_fused, (mI, *s))
    m = [m for label, m, unit in builds if label == "atlas"][0]
    q, qd, u = uniform_states(m.n, MAIN_B, torch.float32, gen)
    _, pairs = tile_pairs()
    x = atlas_stages(m, q, qd, u)
    for name in ("grad_cols_finish", "grad_cols", "minv_dense",
                 "minv_dense_norhs", *SWEEP_TIMED):
        _, kern, _, inputs = pairs[name]
        both(f"atlas f32 B={MAIN_B} {name}", kern,
             (m, *inputs((q, qd, u), x)))
    both(f"atlas f32 B={MAIN_B} fd_grad_staged", staged.fd_grad_staged,
         (m, q, qd, u))
    log(f"-- probe done at {time.perf_counter() - t0:.1f} s")


GEOMS_SEED = 4           # --geoms-fault's own generator
GEOMS_FAULT_CHUNKS = 16  # × PHASE1_B states
# chunk of GEOMS_SEED's draws → the states phase 1 holds: those where the
# kernel built with FMA contraction and true division by dt and the cell
# size was past the float32 check — 498 held normwise, 576 held as
# sensitive, the worst of each kind (chunks 7 and 9 held states 573, and
# 61 and 162, as well; --geoms-fault holds all four) — and those that set
# each output's scale over the chunk
GEOMS_CASES = {0: (497, 498, 632, 704, 731),
               15: (385, 504, 520, 576, 794)}


def phase1_geoms_cases():
    """Free HyQ's float32 step with its ground geoms on the 121² grid on
    GEOMS_CASES' states of GEOMS_SEED's draws, held to its plain version
    as phase 1 holds the whole chunk (sensitive states one by one)."""
    m = ff_model("hyq", torch.float32)
    kern, plain = step_fns("hyq", "121", False, torch.float32, geoms=True)
    draws = geoms_draws(m, max(GEOMS_CASES) + 1)
    for chunk, held in GEOMS_CASES.items():
        sub = [x[..., list(held)].contiguous() for x in draws[chunk]]
        run_pair(f"phase1 free hyq float32 geoms chunk {chunk} states "
                 f"{list(held)} step_ground_terrain_geoms",
                 "step_ground_terrain", kern, plain, m, sub,
                 step_switches(m, sub[:6], "hyq", "121", geoms=True)[0],
                 sensitive=True)


def geoms_draws(m, chunks):
    """GEOMS_SEED's draws of free HyQ's step with its ground geoms on the
    121² grid: ``chunks`` chunks of PHASE1_B states, each the inputs
    (quat, pos, q, vb, qd, tau, mu) as phase 1 draws them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GEOMS_SEED)
    out = []
    for _ in range(chunks):
        s = ff_states(m, PHASE1_B, gen, "hyq")
        out.append((*s, *step_inputs(m, PHASE1_B, gen, "hyq", False,
                                     geoms=True)))
    return out


@contextmanager
def true_division():
    """A tensor divided by a Python number as a true division: on the card
    torch multiplies by the number's reciprocal instead, a rounding apart."""
    div, rdiv = torch.Tensor.__truediv__, torch.Tensor.__rtruediv__

    def true_div(a, b):
        if isinstance(b, (int, float)):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
        return div(a, b)

    def true_rdiv(a, b):
        if isinstance(b, (int, float)):
            return div(torch.full_like(a, b), a)
        return rdiv(a, b)
    torch.Tensor.__truediv__, torch.Tensor.__rtruediv__ = true_div, true_rdiv
    try:
        yield
    finally:
        torch.Tensor.__truediv__, torch.Tensor.__rtruediv__ = div, rdiv


def geoms_fault():
    """``chip_smoke.py --geoms-fault``: free HyQ's float32 ground step with
    its 14 geom contacts on the 121² grid (phase 1's
    step_ground_terrain_geoms) on GEOMS_FAULT_CHUNKS chunks of PHASE1_B
    states from its own generator (geoms_draws), each chunk held to its
    plain version by phase 1's check (sensitive states one by one). For
    each chunk it prints the states where the kernel is its plain float32
    version bit for bit, the check's verdict and the states past it; and
    the same for the plain version itself run with true division in place
    of torch's product with a Python number's reciprocal — states whose
    error one rounding moves further than the input draws of
    ``sensitivity`` do. Fails if the kernel fails the check on a chunk."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    phase0_toolchain()
    name_limit = card()
    gl = cff.geom_links(cff.ground_geoms_static(step_geoms(torch.float64,
                                                           "cpu")))
    t0 = time.perf_counter()
    lib = _build.library(ff_model("hyq"), links=FF_ROBOTS["hyq"][1] + gl)
    log(f"build hyq (free flyer, ground geoms): "
        f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas_report(next(iter(lib.logs.values()))):
        log(line)
    m = ff_model("hyq", torch.float32)
    m64 = m.to(dtype=torch.float64)
    kern, plain = step_fns("hyq", "121", False, torch.float32, geoms=True)
    n_same = n_past = n_true = 0
    for chunk, args in enumerate(geoms_draws(m, GEOMS_FAULT_CHUNKS)):
        got = _as_tuple(kern(m, *args))
        args64 = [x.double() for x in args]
        ref = _as_tuple(plain(m64, *args64))
        p32 = _as_tuple(plain(m, *args))
        with true_division():
            pt = _as_tuple(plain(m, *args))
        keep, _ = step_switches(m, args[:6], "hyq", "121", geoms=True)
        sens = sensitivity(plain, m64, args64, ref, torch.float32)
        ok, past = {}, {}
        for name, x in (("kernel", got), ("true", pt)):
            _, rest, t, s_ok, _, _, past[name] = _split_sensitive(
                x, ref, sens, keep, _f32_tol(p32, ref), p32)
            rel = compare(tuple(o[..., rest] for o in x),
                          tuple(o[..., rest] for o in ref))[0]
            ok[name] = s_ok and rel <= t
        same = torch.stack([(a == b).reshape(-1, a.shape[-1]).all(0)
                            for a, b in zip(got, p32)]).all(0)
        n_same += int(same.sum())
        n_past += not ok["kernel"]
        n_true += not ok["true"]
        log(f"geoms-fault chunk {chunk}: the kernel is its plain float32 "
            f"version bit for bit on {int(same.sum())} of {PHASE1_B} "
            f"states; the check: the kernel "
            f"{'passes' if ok['kernel'] else 'FAILS'} (states past "
            f"{torch.nonzero(past['kernel']).flatten().tolist()}), the plain "
            f"version with true division {'passes' if ok['true'] else 'FAILS'}"
            f" (states past {torch.nonzero(past['true']).flatten().tolist()})")
        err = {name: state_errors(x, ref)
               for name, x in (("kernel", got), ("plain", p32),
                               ("true", pt))}
        for b in torch.nonzero(past["kernel"] | past["true"]).flatten():
            b = int(b)
            log(f"geoms-fault chunk {chunk} state {b}: error kernel "
                f"{err['kernel'][b]:.3e}, plain f32 {err['plain'][b]:.3e}, "
                f"plain f32 with true division {err['true'][b]:.3e}; "
                f"sensitivity ({SENS_DRAWS} draws) {sens[b]:.3e}")
    log(f"geoms-fault: of {GEOMS_FAULT_CHUNKS * PHASE1_B} states the kernel "
        f"is its plain version bit for bit on {n_same}; of "
        f"{GEOMS_FAULT_CHUNKS} chunks the kernel fails the check on "
        f"{n_past}, the plain version with true division on {n_true}; card "
        f"{name_limit}")
    if n_past:
        raise SystemExit("geoms-fault: the kernel fails the check")


V_SEED = 2               # phase V's own generator: earlier phases unchanged
V_BATCHES = (1 << 14, MAIN_B)   # bench_dense_minv.py's two batches
V_HEAD = 1024            # each new kernel's head against its plain version


@contextmanager
def one_thread(n):
    """Route M⁻¹ and the composition FD to their single-thread kernels up
    to ``n`` joints (built for every robot; nothing is rebuilt) — the JAX
    benchmarks' lane-recursion arms (bench_dense_minv.py:63-79)."""
    saved = _build.MAX_KERNEL_JOINTS
    _build.MAX_KERNEL_JOINTS = max(n, saved)
    try:
        yield
    finally:
        _build.MAX_KERNEL_JOINTS = saved


def v_atlas_cases(mA):
    """Atlas's phase-V calls, name → (f(q, q̇, u), the launches one call
    makes): bench_dense_minv.py:86-101's seven cases (its lane-recursion
    arms as the single-thread kernels), bench_bf16_staging.py's bf16 arm,
    and the other options of the staged ∇FD and ∂ID."""
    def fdg(**kw):
        return lambda q, qd, u: staged.fd_grad_staged(mA, q, qd, u, **kw)

    def one(fn):
        def call(q, qd, u):
            with one_thread(mA.n):
                return fn(q, qd, u)
        return call

    def thread(fn):
        def call(q, qd, u):
            with design("thread"):
                return fn(q, qd, u)
        return call
    k1, k4, k5 = {"bias_and_v": 1}, {"af": 1}, {"grad_cols_finish": 1}
    return {
        "fd_grad dense": (fdg(), {**k1, "minv_dense": 1, **k4, **k5}),
        "fd_grad dense mergeaf": (fdg(merge_af=True),
                                  {**k1, "minv_af": 1, **k5}),
        "fd_grad recursion": (fdg(minv_impl="recursion"),
                              {**k1, "minv_ud": 1, "minv_cols": 1, **k4,
                               **k5}),
        "minv dense-kernel": (
            lambda q, qd, u: staged.minv_qdd_dense_staged(mA, q)[0],
            {"minv_dense": 1}),
        "minv one-thread": (one(lambda q, qd, u: fused.minv_fused(mA, q)),
                            {"minv": 1}),
        "fd factor-solve": (
            lambda q, qd, u: staged.fd_dense_staged(mA, q, qd, u),
            {"fd_dense": 1}),
        "fd one-thread": (
            one(lambda q, qd, u: fused.forward_dynamics_fused(mA, q, qd, u)),
            {"fd": 1}),
        "fd_grad bf16": (fdg(stage_dtype=torch.bfloat16),
                         {**k1, "minv_dense": 1, "af_bf16": 1,
                          "grad_cols_finish_bf16": 1}),
        "fd_grad per-side": (fdg(merge_sides=False),
                             {**k1, "minv_dense": 1, **k4,
                              "grad_cols_finish_side": 2}),
        "fd_grad unfused": (fdg(fuse_finish=False),
                            {**k1, "minv_dense": 1, **k4, "grad_cols": 1}),
        "id_grad per-side": (
            lambda q, qd, u: staged.id_grad_staged(mA, q, qd, u,
                                                   merge_sides=False),
            {"vaf": 1, "grad_cols_side": 2}),
        "id_grad bf16": (
            lambda q, qd, u: staged.id_grad_staged(
                mA, q, qd, u, stage_dtype=torch.bfloat16),
            {"vaf": 1, "grad_cols_bf16": 1}),
        "minv_staged": (lambda q, qd, u: staged.minv_staged(mA, q),
                        {"minv_ud": 1, "minv_cols": 1}),
        "fd_staged": (lambda q, qd, u: staged.fd_staged(mA, q, qd, u),
                      {**k1, "minv_ud": 1, "minv_cols": 1}),
        # the one-thread K1, K2′, K4, K5 and vaf that the CTA tiles
        # replaced
        "fd_grad dense one-thread": (
            thread(fdg()), {"bias_and_v_thread": 1, "minv_dense_thread": 1,
                            "af_thread": 1, "grad_cols_finish_thread": 1}),
        "fd_grad bf16 one-thread": (
            thread(fdg(stage_dtype=torch.bfloat16)),
            {"bias_and_v_thread": 1, "minv_dense_thread": 1,
             "af_bf16_thread": 1, "grad_cols_finish_bf16_thread": 1}),
        "id_grad one-thread": (
            thread(lambda q, qd, u: staged.id_grad_staged(mA, q, qd, u)),
            {"vaf_thread": 1, "grad_cols_thread": 1}),
        "minv one-thread K2′": (
            thread(lambda q, qd, u: staged.minv_qdd_dense_staged(mA, q)[0]),
            {"minv_dense_thread": 1}),
    }


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1.0))


def crba_dense(m, q):
    """The plain CRBA M + diag(armature), batch first (B, n, n)."""
    M = blops.crba_bl(m, blops.joint_transforms_bl(m, q))
    zero = torch.zeros_like(q[0:1])
    return torch.stack([torch.cat([zero if e is None else e for e in row])
                        for row in M]).permute(2, 0, 1).contiguous()


LIB_CALLS = 20   # the library yardstick's calls (its time moved 2× between runs)


def chol_library_ms(tag, m, q, rhs, name_limit, inverse=None):
    """library_ms of a kernel that contains a Cholesky: the batched
    ``torch.linalg.cholesky_ex`` then ``torch.cholesky_inverse`` (rhs None,
    or ``inverse``) and ``torch.cholesky_solve`` (rhs given) on the plain
    CRBA matrices of the same states — the factor stage only, not the whole
    function; the median of LIB_CALLS calls after two."""
    M = crba_dense(m, q)
    inverse = rhs is None if inverse is None else inverse
    r = None if rhs is None else rhs.T.contiguous()[..., None]

    def fn(M, r):
        L = torch.linalg.cholesky_ex(M)[0]
        return ((torch.cholesky_inverse(L),) if inverse else ()) + (
            () if r is None else (torch.cholesky_solve(r, L),))
    ms = time_ms(fn, (M, r), calls=LIB_CALLS)
    what = " + ".join(["torch.linalg.cholesky_ex"]
                      + ["torch.cholesky_inverse"] * inverse
                      + ["torch.cholesky_solve"] * (r is not None))
    log(f"library {tag}: {what} on the plain CRBA matrices "
        f"({M.shape[-1]}², f32, B={M.shape[0]}): {ms:.3f} ms (median of "
        f"{LIB_CALLS}) — the factor stage only; card {name_limit}")
    return ms


def phaseV_variants(plain_times):
    """The fixed-base M⁻¹ and FD variants at the JAX benchmarks' shapes,
    float32, on their own generator: Atlas's cases (v_atlas_cases) once each
    at 2¹⁸ with every count set to 0 before and read after — the launches
    of each call pinned —, the ∇FD parity dense vs recursion and bf16 vs
    full precision (bench_dense_minv.py:114-120, bench_bf16_staging.py;
    bf16 held to BF16_REL, max|Δ| / max(1, max|full|) as JAX's test),
    then each case timed at 2¹⁴ and 2¹⁸; iiwa-14 and HyQ ∇FD with
    ``minv_impl`` recursion and dense at 2¹⁸ (bench_dense_headline.py;
    HyQ on the single-thread kernels, as JAX runs it on its single tile)
    with their float64-golden parity heads; iiwa-14 and Atlas
    ``forward_dynamics_fused`` against ABA (bench_aba.py); then each new
    kernel's time, plain time, bound, head against its plain version, and
    the Cholesky library time where the kernel factors.
    → (launches, max_abs, times)."""
    name_limit = card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(V_SEED)
    mA = gt.load_robot(ROBOTS["atlas"], dtype=torch.float32, device="cuda")
    mI = gt.load_robot(ROBOTS["iiwa14"], dtype=torch.float32, device="cuda")
    mH = gt.load_robot(ROUTE_ROBOTS["hyq"], dtype=torch.float32,
                       device="cuda")
    sA = uniform_states(mA.n, MAIN_B, torch.float32, gen)
    sI = uniform_states(mI.n, MAIN_B, torch.float32, gen)
    sH = uniform_states(mH.n, MAIN_B, torch.float32, gen)
    cases = v_atlas_cases(mA)
    # the main-path run: one call of each case
    _launch.reset_launches()
    outs = {}
    for case, (fn, expect) in cases.items():
        before = dict(_launch.LAUNCHES)
        outs[case] = _as_tuple(fn(*sA))
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
                if v != before[k]}
        check_finite(f"phaseV atlas {case}", outs[case])
        if made != expect:
            raise RuntimeError(f"phaseV atlas {case}: launches {made}, "
                               f"expected {expect}")
    for fam in ("recursion", "dense"):
        for mm, s, label in ((mI, sI, "iiwa14"), (mH, sH, "hyq")):
            with route_limits():
                outs[f"{label} {fam}"] = fused.fd_grad_fused(
                    mm, *s, minv_impl=fam)
    # the one-thread recursion ∇FD the tile replaced
    with design("thread"):
        outs["iiwa14 recursion one-thread"] = fused.fd_grad_fused(mI, *sI)
    for mm, s, label in ((mI, sI, "iiwa14"), (mA, sA, "atlas")):
        outs[f"{label} fd"] = fused.forward_dynamics_fused(mm, *s)
        outs[f"{label} aba"] = fused.forward_dynamics_aba_fused(mm, *s)
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    log(f"phaseV launches of the main-path run: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for side, k in (("ddq", 0), ("ddqd", 1)):
        for a, b, what in (("fd_grad recursion", "fd_grad dense",
                            "dense_vs_recursion"),
                           ("fd_grad bf16", "fd_grad dense", "bf16"),
                           ("fd_grad per-side", "fd_grad dense", "per-side"),
                           ("fd_grad unfused", "fd_grad dense", "unfused"),
                           ("fd_grad dense mergeaf", "fd_grad dense",
                            "mergeaf"),
                           ("fd_grad dense one-thread",
                            "fd_grad dense", "one-thread")):
            rel = _rel(outs[a][k], outs[b][k])
            held = what == "bf16"
            ok = not held or rel <= BF16_REL
            log(f"phaseV parity atlas B={MAIN_B} {side} {what}: rel err "
                f"{rel:.3e} (scale {float(outs[b][k].abs().max()):.3e})"
                + (f" tol {BF16_REL:.0e} {'ok' if ok else 'FAIL'}"
                   if held else ""))
            if not ok:
                raise RuntimeError(f"phaseV atlas {side}: bf16 staging too "
                                   f"far from full precision ({rel:.3e})")
    for a, b in (("minv_staged", "minv dense-kernel"),
                 ("minv one-thread", "minv dense-kernel"),
                 ("fd factor-solve", "atlas aba"),
                 ("fd one-thread", "atlas aba"), ("fd_staged", "atlas aba"),
                 ("iiwa14 fd", "iiwa14 aba")):
        log(f"phaseV parity {a} vs {b}: rel err "
            f"{_rel(_as_tuple(outs[a])[0], _as_tuple(outs[b])[0]):.3e}")
    for label, mm, s, urdf in (("iiwa14", mI, sI, ROBOTS["iiwa14"]),
                               ("hyq", mH, sH, ROUTE_ROBOTS["hyq"])):
        desc = gt.parse_urdf(urdf)
        for fam in ("recursion", "dense"):
            J = torch.cat(outs[f"{label} {fam}"], 1).permute(2, 0, 1)
            parity_head(desc, J, *(x.T for x in s),
                        f"phaseV {label} fd_grad minv_impl={fam}")
    tile, thread = (torch.cat(outs[f"iiwa14 recursion{k}"])
                    for k in ("", " one-thread"))
    log(f"phaseV parity iiwa14 B={MAIN_B} fd_grad tile vs one-thread: rel "
        f"err {_rel(tile, thread):.3e}")
    del outs, tile, thread

    for B in V_BATCHES:
        s = [x[..., :B].contiguous() for x in sA]
        for case, (fn, _) in cases.items():
            ms = time_ms(fn, s)
            log(f"phaseV atlas B={B} {case}: {ms:.3f} ms "
                f"({B / ms * 1e3:.3e} evals/s); card {name_limit}")
    for label, mm, s in (("iiwa14", mI, sI), ("hyq", mH, sH)):
        with route_limits():
            for fam in ("recursion", "dense"):
                ms = time_ms(lambda *a: fused.fd_grad_fused(
                    mm, *a, minv_impl=fam), s)
                log(f"phaseV {label} B={MAIN_B} fd_grad_fused "
                    f"minv_impl={fam}: {ms:.3f} ms ({MAIN_B / ms * 1e3:.3e} "
                    f"evals/s); card {name_limit}")
    for label, mm, s in (("iiwa14", mI, sI), ("atlas", mA, sA)):
        for fn in (fused.forward_dynamics_fused,
                   fused.forward_dynamics_aba_fused):
            ms = time_ms(fn, (mm, *s))
            log(f"phaseV {label} B={MAIN_B} {fn.__name__}: {ms:.3f} ms "
                f"({MAIN_B / ms * 1e3:.3e} evals/s); card {name_limit}")

    # each new kernel at its main-path shape: iiwa-14's fused.cu variants;
    # Atlas's staged.cu ones on the pipeline's own kernel intermediates
    times, max_abs = {}, {}

    def entry(label, name, kern, plain, mm, args, count=None,
              plain_ms=None):
        times[name] = time_entry(label, name, kern, plain, mm, args,
                                 name_limit, count=count, plain_ms=plain_ms)
        head = [a[..., :V_HEAD].contiguous() for a in args]
        max_abs[name], _ = check_against_plain(
            f"phaseV {label} {name} head ({V_HEAD} states) vs plain",
            kern(mm, *head), plain, mm, head)
    for name, (_, kern, plain, _) in VARIANT_PAIRS.items():
        entry("iiwa14", name, kern, plain, mI, tuple(sI))
    q, qd, u = sA
    x = {}
    c, x["v"] = staged.bias_and_v_staged(mA, q, qd)
    x["umc"] = u - c
    x["Minv"], x["qdd"] = staged.minv_qdd_dense_staged(mA, q, x["umc"])
    x["a"], x["f"] = staged.af_staged(mA, q, qd, x["qdd"], x["v"])
    x["U"], x["Dinv"] = staged.minv_ud_staged(mA, q)
    x["v2"], x["a2"], x["f2"] = staged.vaf_staged(mA, q, qd, u)
    x.update({f"{k}16": staged.to_stage(x[k])
              for k in ("v", "a", "f", "Minv", "v2", "a2", "f2")})
    for name, (_, kern, plain, inputs) in variant_pairs()[1].items():
        entry("atlas", name, kern, plain, mA, tuple(inputs(sA, x)))
    # the one-thread K2′ and K5 (the design the CTA tiles replaced), at the
    # same shapes: bounded by the tiles' counts and beside their plain
    # versions' phase-3 times (the same functions)
    _, spairs = staged_pairs()
    _, tpairs = tile_pairs()
    x.update(c=c)
    with design("thread"):
        for name in ("minv_dense", "grad_cols_finish", "grad_cols",
                     *SWEEP_TIMED):
            _, kern, plain, inputs = tpairs[name]
            entry("atlas", f"{name}_thread", kern, plain, mA,
                  tuple(inputs(sA, x)), count=name,
                  plain_ms=plain_times.get(name, times.get(name, {}).get(
                      "plain_ms")))
        _, kern, plain, _ = PAIRS["fd_grad"]
        entry("iiwa14", "fd_grad_thread", kern, plain, mI, tuple(sI),
              count="fd_grad", plain_ms=plain_times["fd_grad"])
    del x
    times["fd_grad_dense"]["library_ms"] = chol_library_ms(
        "fd_grad_dense iiwa14", mI, sI[0], None, name_limit)
    times["minv_af"]["library_ms"] = chol_library_ms(
        "minv_af / minv_dense atlas", mA, q, None, name_limit)
    times["fd_dense"]["library_ms"] = chol_library_ms(
        "fd_dense atlas", mA, q,
        u - staged.bias_and_v_staged(mA, q, qd)[0], name_limit)
    return launches, max_abs, times


# (JSON name, LAUNCHES key, path, source, TPU kernel it replaces)
RECORD = [
    ("fd_grad", "fd_grad", "iiwa14", FUSED_SRC, TPU + "fused.py:394"),
    ("id_grad", "id_grad", "iiwa14", FUSED_SRC, TPU + "fused.py:433"),
    ("minv", "minv", "iiwa14", FUSED_SRC, TPU + "fused.py:290"),
    ("inverse_dynamics", "inverse_dynamics", "iiwa14", FUSED_SRC,
     TPU + "fused.py:270"),
    ("aba", "aba", "iiwa14", FUSED_SRC, TPU + "fused.py:357"),
    ("inverse_dynamics[atlas]", "inverse_dynamics", "atlas", FUSED_SRC,
     TPU + "fused.py:270"),
    ("aba[atlas]", "aba", "atlas", FUSED_SRC, TPU + "fused.py:357"),
    ("bias_and_v", "bias_and_v", "atlas", STAGED_SRC, TPU + "staged.py:172"),
    ("minv_dense", "minv_dense", "atlas", STAGED_SRC, TPU + "staged.py:218"),
    ("af", "af", "atlas", STAGED_SRC, TPU + "staged.py:453"),
    ("grad_cols_finish", "grad_cols_finish", "atlas", STAGED_SRC,
     TPU + "staged.py:470"),
    ("vaf", "vaf", "atlas", STAGED_SRC, TPU + "staged.py:341"),
    ("grad_cols", "grad_cols", "atlas", STAGED_SRC, TPU + "staged.py:356"),
    ("hessian_vp", "hessian_vp", "smallH", SO_SRC, TPU + "so_fused.py:195"),
    ("hessian", "hessian", "iiwa14H", SO_SRC, TPU + "so_fused.py:220"),
    ("t1_q", "t1", "atlasH", SO_SRC, TPU + "so_staged.py:264"),
    ("t2", "t2", "atlasH", SO_SRC, TPU + "so_staged.py:277"),
    ("t4_q", "t4", "atlasH", SO_SRC, TPU + "so_staged.py:289"),
    ("t5_q_q", "t5", "atlasH", SO_SRC, TPU + "so_staged.py:304"),
    ("md_fd_grad", "md_fd_grad", "free_iiwa14:fd_grad", MD_SRC,
     TPU + "multidof_fused.py:791"),
    ("md_id_grad", "md_id_grad", "free_iiwa14:id_grad", MD_SRC,
     TPU + "multidof_fused.py:771"),
    ("md_id", "md_id", "free_atlas:id", MD_SRC, TPU + "multidof_fused.py:879"),
    ("md_aba", "md_aba", "free_atlas:aba", MD_SRC,
     TPU + "multidof_fused.py:377"),
    ("md_fd", "md_fd", "free_atlas:crba", MD_SRC,
     TPU + "multidof_fused.py:894"),
    ("md_minv_qdd", "md_minv_qdd", "free_atlas:fd_grad", MD_STAGED_SRC,
     TPU + "multidof_staged.py:149"),
    ("md_vaf", "md_vaf", "free_atlas:fd_grad", MD_STAGED_SRC,
     TPU + "multidof_staged.py:109"),
    ("md_grad_cols_finish", "md_grad_cols_finish", "free_atlas:fd_grad",
     MD_STAGED_SRC, TPU + "multidof_staged.py:184"),
    ("md_grad_cols", "md_grad_cols", "free_atlas:id_grad", MD_STAGED_SRC,
     TPU + "multidof_staged.py:184"),
    # K2md without the right-hand side: no entry point takes it (0 launches
    # on every path); held to its plain version and timed all the same
    ("md_minv", "md_minv", "free_atlas:fd_grad", MD_STAGED_SRC,
     TPU + "multidof_staged.py:127"),
    ("fb_aba", "fb_aba", "ff_atlas:aba", FF_SRC,
     TPU + "contact_fused.py:1413"),
    ("fb_fd", "fb_fd", "ff_atlas:chol", FF_SRC,
     TPU + "contact_fused.py:1329"),
    ("stance_fd", "stance_fd", "ff_hyq:stance", FF_SRC,
     TPU + "contact_fused.py:1431"),
    ("fb_aba[hyq]", "fb_aba", "ff_hyq:aba", FF_SRC,
     TPU + "contact_fused.py:1413"),
    ("fb_fd[hyq]", "fb_fd", "ff_hyq:chol", FF_SRC,
     TPU + "contact_fused.py:1329"),
    ("stance_fd[atlas]", "stance_fd", "ff_atlas:stance", FF_SRC,
     TPU + "contact_fused.py:1431"),
    ("step_ground", "step_ground", "step_hyq", FF_SRC,
     TPU + "contact_fused.py:1458"),
    ("step_ground_terrain", "step_ground_terrain", "step_hyq_terrain", FF_SRC,
     TPU + "contact_fused.py:1531"),
    ("step_ground[atlas]", "step_ground", "step_atlas", FF_SRC,
     TPU + "contact_fused.py:1458"),
    ("step_ground[hyq_geoms]", "step_ground", "step_hyq_geoms", FF_SRC,
     TPU + "contact_fused.py:1458"),
    ("md_step_ground", "md_step_ground", "step_md_ball_ant", MD_STEP_SRC,
     TPU + "md_contact_fused.py:185"),
    ("step_ground[collision_step_hyq]", "step_ground",
     "step_collision_step_hyq", FF_SRC, TPU + "contact_fused.py:1458"),
    ("step_ground[loop_ground_step_four_bar]", "step_ground",
     "step_loop_ground_step_four_bar", FF_SRC, TPU + "contact_fused.py:1458"),
    # phase V: the fixed-base M⁻¹ and FD variants
    ("fd_grad_dense", "fd_grad_dense", "variants", FUSED_SRC,
     TPU + "fused.py:394"),
    ("fd", "fd", "variants", FUSED_SRC, TPU + "fused.py:326"),
    ("fd_dense", "fd_dense", "variants", STAGED_SRC, TPU + "staged.py:294"),
    ("minv_ud", "minv_ud", "variants", STAGED_SRC, TPU + "staged.py:186"),
    ("minv_cols", "minv_cols", "variants", STAGED_SRC, TPU + "staged.py:186"),
    ("minv_af", "minv_af", "variants", STAGED_SRC, TPU + "staged.py:257"),
    ("af_bf16", "af_bf16", "variants", STAGED_SRC, TPU + "staged.py:373"),
    ("grad_cols_finish_bf16", "grad_cols_finish_bf16", "variants",
     STAGED_SRC, TPU + "staged.py:373"),
    ("grad_cols_finish_side", "grad_cols_finish_side", "variants",
     STAGED_SRC, TPU + "staged.py:373"),
    ("grad_cols_bf16", "grad_cols_bf16", "variants", STAGED_SRC,
     TPU + "staged.py:319"),
    ("grad_cols_side", "grad_cols_side", "variants", STAGED_SRC,
     TPU + "staged.py:319"),
    # phase V: the one-thread K2′ and K5 that the CTA tiles replaced
    ("minv_dense_thread", "minv_dense_thread", "variants", STAGED_SRC,
     TPU + "staged.py:218"),
    ("grad_cols_finish_thread", "grad_cols_finish_thread", "variants",
     STAGED_SRC, TPU + "staged.py:470"),
    ("grad_cols_thread", "grad_cols_thread", "variants", STAGED_SRC,
     TPU + "staged.py:356"),
    # phase V: the one-thread K1, K4, vaf and recursion ∇FD that the CTA
    # tiles replaced
    ("bias_and_v_thread", "bias_and_v_thread", "variants", STAGED_SRC,
     TPU + "staged.py:172"),
    ("af_thread", "af_thread", "variants", STAGED_SRC, TPU + "staged.py:453"),
    ("af_bf16_thread", "af_bf16_thread", "variants", STAGED_SRC,
     TPU + "staged.py:373"),
    ("vaf_thread", "vaf_thread", "variants", STAGED_SRC,
     TPU + "staged.py:341"),
    ("fd_grad_thread", "fd_grad_thread", "variants", FUSED_SRC,
     TPU + "fused.py:394"),
]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()

    def done(phase):
        log(f"-- {phase} done at {time.perf_counter() - t0:.1f} s")

    phase0_toolchain()
    # phase 1 and the routes hold the single-thread kernels of robots past
    # the routing limits too, and the staged multi-dof ones of robots under
    # MAX_MD_GRAD_NV
    with route_limits():
        # in the order the checks need them: phase1_kernels_vs_plain's
        # robots, then the free flyers' and the steps' libraries (their
        # checks run beside the last builds), then the rest
        first = ("iiwa14", "branched_arm", "atlas", TILE_ROBOT)
        robots = {**ROBOTS, **ROUTE_ROBOTS, **HESS_ROUTE_ROBOTS}
        finish_builds = start_builds(
            {**{label: gt.load_robot(robots[label], device="cuda")
                for label in first},
             "chain5p": gt.load_robot(FD_TILE_ROBOTS["chain5p"],
                                      device="cuda"),
             **{f"{label} (free flyer{', stance' if k else ''})":
                ff_model(label)
                for label in FF_CHECK for k in (False, True)},
             **{label: model for label, (model, _, _) in
                step_builds().items()},
             **{label: gt.load_robot(u, device="cuda")
                for label, u in robots.items() if label not in first},
             **{f"{label} (multi-dof)": md_model(label)
                for label in MD_ROBOTS}},
            staged={f"{label} (multi-dof)" for label in
                    (*MD_ROUTE_ROBOTS, *MD_STAGED_CHECK)},
            links={**{f"{label} (free flyer, stance)":
                      FF_ROBOTS[label][1] for label in FF_CHECK},
                   **{label: links for label, (_, links, _) in
                      step_builds().items()}},
            pairs={label: pairs for label, (_, _, pairs) in
                   step_builds().items() if pairs},
            only={"chain5p": ("fused.cu",)})
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        phase1_kernels_vs_plain(gen)
        # the bounds' operation counts run on the CPU in a child process,
        # beside every GPU phase up to phase 3 (started beside the last
        # builds, so that phase 3 need not wait for it)
        COUNTS.start()
        # the free-flyer kernels and the steps route by no limit
        phase1_free_flyer(gen)
        phase1_geoms_cases()
        # the collision and loop cases draw from a generator of their own,
        # so the later phases' states are the ones they drew before those
        # cases were added
        rows_gen = torch.Generator(device="cuda")
        rows_gen.manual_seed(ROWS_SEED)
        phase1_rows(rows_gen)
        finish_builds()
        done("builds")
    phase1_multidof(gen)
    md_stage_abs = phase1_md_staged(gen)
    phase1_md_step(gen)
    md_cross_check(gen)
    done("phase 1")
    m, launches, max_abs, parity = phase2_main_path(gen)
    done("phase 2")
    mA, atlas_states, a_launches, a_max_abs, a_parity, a_plain = \
        phaseA_atlas(gen)
    max_abs.update(a_max_abs)
    done("phase A")
    h_launches, h_max_abs, sA = phaseH_second_order(gen, mA)
    max_abs.update(h_max_abs)
    done("phase H")
    times = phase3_times(m, mA, atlas_states, gen)
    done("phase 3 first order")
    times.update(phase3_second_order(mA, sA, gen))
    done("phase 3 second order")
    with route_limits():
        phase3_routes(gen)
        phase3_hessian_routes(gen)
    done("phase 3 routes")
    phase3_k5_width(mA, atlas_states)
    done("phase 3 K5 widths")
    del mA, atlas_states, sA
    md_launches, md_max_abs, md_models, md_st = phaseM_multidof(gen)
    done("phase M")
    times.update(phase3_multidof(md_models, md_st, gen))
    del md_models, md_st
    done("phase 3 multi-dof")
    with route_limits():
        phase3_md_routes(gen)
    done("phase 3 multi-dof routes")
    ff_launches, ff_max_abs, ff_models, ff_st = phaseF_free_flyer(gen)
    done("phase F")
    times.update(phase3_free_flyer(ff_models, ff_st))
    del ff_models, ff_st
    done("phase 3 free flyer")
    st_launches, st_max_abs, st_models, st_st = phaseS_ground_step(gen)
    done("phase S")
    times.update(phase3_ground_step(st_models, st_st))
    del st_models, st_st
    done("phase 3 ground step")
    md_launches2, md_max_abs2, md_models2, md_st2 = phaseS_md_and_geoms(gen)
    st_launches.update(md_launches2)
    done("phase S md step and ground geoms")
    times.update(phase3_md_and_geoms(md_models2, md_st2))
    del md_models2, md_st2
    done("phase 3 md step and ground geoms")
    rows_launches, rows_max_abs, rows_models, rows_st = phaseS_rows(gen)
    st_launches.update(rows_launches)
    done("phase S collision and loops")
    times.update(phase3_rows(rows_models, rows_st))
    del rows_models, rows_st
    done("phase 3 collision and loops")
    v_launches, v_max_abs, v_times = phaseV_variants(
        {k: times[k]["plain_ms"] for k in ("minv_dense", "grad_cols_finish",
                                           "grad_cols", "fd_grad",
                                           *SWEEP_TIMED) if k in times})
    max_abs.update(v_max_abs)
    times.update(v_times)
    times["minv_dense_thread"]["library_ms"] = \
        times["minv_dense"]["library_ms"]
    done("phase V")
    max_abs.update({name: md_max_abs[f"{label}:{fam}"]
                    for name, (label, fam) in MD_TIMED.items()})
    max_abs.update(md_stage_abs)
    max_abs.update({name: ff_max_abs[f"{label}:{entry}"]
                    for name, (label, entry) in FF_TIMED.items()})
    max_abs.update({name: st_max_abs[cell]
                    for name, cell in STEP_TIMED.items()})
    max_abs["md_step_ground"] = md_max_abs2["md_ball_ant"]
    max_abs["step_ground[hyq_geoms]"] = md_max_abs2["hyq_geoms"]
    max_abs.update({f"step_ground[{case}]": rows_max_abs[case]
                    for case in ROWS_PATHS})
    path_launches = {"iiwa14": launches, "atlas": a_launches, **h_launches,
                     **md_launches,
                     **{f"ff_{k}": v for k, v in ff_launches.items()},
                     **{f"step_{k}": v for k, v in st_launches.items()},
                     "variants": v_launches}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": path_launches[path][key], "max_abs_err": max_abs[name],
         **{"library_ms": None, **times[name]}}
        for name, key, path, src, tpu in RECORD]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--count-ops"]:
        count_ops_child()
    elif sys.argv[1:2] == ["--md-profile"]:
        md_profile_child(sys.argv[2])
    elif sys.argv[1:2] == ["--step-profile"]:
        step_profile_child()
    elif sys.argv[1:2] == ["--tile-probe"]:
        tile_probe()
    elif sys.argv[1:2] == ["--geoms-fault"]:
        geoms_fault()
    elif sys.argv[1:2] == ["--atlas-profile"]:
        atlas_profile_child()
    else:
        try:
            main()
        finally:
            COUNTS.stop()
