"""Build the CUDA kernels of ``csrc/`` for one robot topology, at first use.

One shared library per topology and source: for a single-dof robot
(``RobotModel``) ``nvcc`` compiles ``csrc/fused.cu`` (the single-kernel
families), ``csrc/staged.cu`` (the staged large-robot pipeline) and
``csrc/so.cu`` (the second-order kernels); for a multi-dof robot
(``MultiDofModel``) ``csrc/md.cu`` (the ball- and free-joint families) and,
past ``MAX_MD_GRAD_NV`` velocity coordinates, ``csrc/md_staged.cu`` (the
staged multi-dof pipeline), and for each set of contact links
``csrc/md_step.cu`` (its ground step); for a free flyer (``FreeFlyerModel``)
``csrc/ff.cu`` — its ABA and mass-matrix FD, or, in a library of its own
for each set of contact links (and of a ground step's collision and loop
links), its stance FD and its ground steps. All are built for ``sm_90a``
at once, with the joint count, parent indices, joint types and contact
links passed as ``-D`` macros (``csrc/rbd.cuh``, ``csrc/md.cuh``,
``csrc/ff.cuh``). A unit a robot does not build by
default (the staged multi-dof unit of a small robot, forced by a test) is
built when a launch first asks for it.
The libraries have a plain C interface and are loaded with ``ctypes``; they
land in ``build/torch_kernels/`` at the repository root, keyed by the
topology and a hash of the sources, each beside a ``.log`` holding nvcc's
and ptxas's output (registers, spills and stack frame per kernel). A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = ("rbd.cuh", "aba.cuh", "chol.cuh", "staged.cuh", "tile.cuh",
            "dual.cuh", "so.cuh", "md.cuh", "md_staged.cuh", "contact.cuh",
            "ff.cuh", "md_step.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# a unit's nvcc flags past the common ones: ff.cu builds without FMA
# contraction, so its ground step forms every product and sum as its plain
# version does (a float32 step with ground geoms reads the plain version bit
# for bit, also where a near-singular Delassus G amplifies one rounding)
UNIT_FLAGS = {"ff.cu": ("-fmad=false",)}

# The single-thread ∇FD, ∂ID and M⁻¹ kernels keep O(n²) values a state in
# local memory (∇FD's frame is ≈ 28·n² values) while the staged kernels
# (staged.cu) hold 18·n·cb + O(n). Past this joint count those three
# families, and the composition FD, take the staged route (the ∇FD and ∂ID
# kernels are not built there); RNEA and ABA, O(n) a state, run on one
# thread for every robot. Set where the two routes' ∇FD times cross on an
# H100 (chip_smoke.py's routes phase, f32, 2¹⁸ states): the single-thread
# kernel is faster at 9, 10 and 11 joints, the staged pipeline at 12 and 16.
MAX_KERNEL_JOINTS = 11
# Values of the K5 ∂-tensor arrays (dv, da, df: 18·n·cb) a thread may hold;
# sets the default column-block width (default_col_block): cb = 4 at Atlas,
# which chip_smoke.py times faster than blocks of 2 and than a build 7
# wide.
_K5_VALUES = 2048
# The single-thread Hessian kernel (csrc/so.cu) runs the ∇FD body and M⁻¹
# in dual numbers along one direction a thread. It is built, and the full
# Hessian takes it, up to MAX_HESSIAN_JOINTS; past it the full Hessian is
# n calls of the staged λᵀ·H pipeline (T1/T2/T4/T5), 5.2× the single-thread
# kernel's time at 7 joints and 4.1× at 12 on an H100 (chip_smoke.py's
# routes phase, f32, 2¹⁶ states). λᵀ·H takes the single-thread kernel only
# up to MAX_HESSIAN_VP_JOINTS: the staged pipeline sweeps 2n directions,
# not 3n, and stages no n×n tangent; the single-thread kernel was faster
# at 2 joints (2.6×), the staged one at every count timed from 5 to 12
# (1.09× at 5, 1.35× at 7, 2.9× at 12). The two limits are the JAX
# package's two gates (so_fused.full_block and vp_block, api.py:499, :525).
MAX_HESSIAN_JOINTS = 12
MAX_HESSIAN_VP_JOINTS = 2
# The multi-dof ∂ID and ∇FD kernels (csrc/md.cu) hold the ∂v/∂a/∂f column
# tensors of every joint (18·n·nv values) and the (nv, nv) factor, ∂c and
# M⁻¹ on one thread. They are built, and the two gradient families run on
# them, up to this many velocity coordinates; past it the families take
# the staged multi-dof pipeline (csrc/md_staged.cu), whose K5md holds
# 18·n·cb. Set where the two routes' times cross on an H100 (chip_smoke.py's
# multi-dof routes phase, f32, 2¹⁶ states): the single-thread ∇FD is
# faster at nv 7 and 13, the staged one at 18 (free HyQ, 1.21×), 26 and 34
# (free Atlas, 1.88×); ∂ID ties at 18.
MAX_MD_GRAD_NV = 13
# Values of the K5md ∂-tensor arrays a thread may hold; sets md_col_block:
# cb = 4 at free Atlas (18·29·4 = 2088 values, the K5 frame of fixed-base
# Atlas), which chip_smoke.py times against narrower blocks.
_MD_K5_VALUES = 2560
# The CTA-tile K5 and K2′ (csrc/tile.cuh): a tile of states a CTA, each
# state's working set in shared memory. A CTA may opt into at most this
# much dynamic shared memory on an H100 (227 KB); it holds the robot's
# 152·n constants, the topology tables (int16) and the tile.
SMEM_BYTES = 232448
TILE_MAX_STATES = 32
# The CTA-tile RNEA sweeps (K1, K4, ∂ID's vaf) and the recursion ∇FD
# (csrc/tile.cuh) are sized for TILE_CTAS CTAs an SM, so one CTA's loads
# and barriers overlap another's work: each takes at most an SM's 228 KB
# over TILE_CTAS, less the 1 KB the card keeps for every CTA.
SM_SMEM_BYTES = 233472
TILE_CTAS = 2
# threads a CTA of the sweep and ∇FD tiles, f32 / f64 (with TILE_CTAS CTAs
# an SM: ≤ 64 / 128 registers a thread for the sweeps, ≤ 85 / 128 for the
# ∇FD). `chip_smoke.py --tile-configs` times other settings on an H100
# (PERF.md): K1, K4 and vaf are fastest at 2 × 512 of those tried, the ∇FD
# reads within 2 % at 2 × 384, 1 × 512 and 2 × 512.
VAF_THREADS = (512, 256)
FD_THREADS = (384, 256)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_D = ctypes.c_double
_I = ctypes.c_int
# unit → entry → argtypes (every entry has an _f32 and an _f64 variant)
_UNITS = {
    "fused.cu": {
        # consts, q, qd, u, ddq, ddqd, B, gravity, stream (the CTA tile;
        # "_thread": the one-thread-per-state kernel it replaced)
        "grid_fd_grad": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        "grid_fd_grad_thread": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, qdd, dq, dqd, B, gravity, stream
        "grid_id_grad": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, u, ddq, ddqd, B, gravity, stream (minv_impl="dense")
        "grid_fd_grad_dense": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, M, B, stream
        "grid_minv": (_P, _P, _P, _LL, _P),
        # consts, q, qd, u, qdd, B, gravity, stream (q̈ = M⁻¹(u − c))
        "grid_fd": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, qdd (or NULL), c, B, gravity, stream
        "grid_rnea": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, u, qdd, B, gravity, stream
        "grid_aba": (_P, _P, _P, _P, _P, _LL, _D, _P),
    },
    "staged.cu": {
        # consts, q, qd, c, v, B, gravity, stream (K1, K4 and vaf: the
        # sweep tile; "_thread": the one-thread kernel it replaced)
        "grid_bias_v": (_P, _P, _P, _P, _P, _LL, _D, _P),
        "grid_bias_v_thread": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, qdd, v, a, f, B, s16 (v in bf16), gravity, stream
        "grid_af": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _D, _P),
        "grid_af_thread": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _D, _P),
        # consts, q, qd, qdd, v, a, f, B, gravity, stream
        "grid_vaf": (_P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
        "grid_vaf_thread": (_P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, rhs (or NULL), M, qdd (or NULL), B, stream (the CTA
        # tile; "_thread": the one-thread-per-state kernel it replaced)
        "grid_minv_dense": (_P, _P, _P, _P, _P, _LL, _P),
        "grid_minv_dense_thread": (_P, _P, _P, _P, _P, _LL, _P),
        # consts, q, qd, v, a, f, Minv (or NULL), dq, dqd, B, cb, sides (1
        # ∂c/∂q, 2 ∂c/∂q̇, 3 both), s16 (v, a, f, Minv in bf16), gravity,
        # stream (the CTA tile; "_thread": the one-thread kernel)
        "grid_grad_cols": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                           _I, _D, _P),
        "grid_grad_cols_thread": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                                  _I, _I, _I, _D, _P),
        # consts, q, qd, u, qdd, B, gravity, stream (factor and solve)
        "grid_fd_dense": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, umc, v, M, a, f, B, gravity, stream (K2″)
        "grid_minv_af": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, U, Dinv, B, stream (K2)
        "grid_minv_ud": (_P, _P, _P, _P, _LL, _P),
        # consts, q, U, Dinv, M, B, cb, stream (K3, every block one launch)
        "grid_minv_cols": (_P, _P, _P, _P, _P, _LL, _I, _P),
    },
    "so.cu": {
        # consts, q, qd, u, lam (or NULL: the full tensor), out, B, gravity,
        # stream
        "grid_hessian": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, dc, dv, B, which, gravity, stream
        "grid_t1": (_P, _P, _P, _P, _P, _LL, _I, _D, _P),
        # consts, q, lamM, qdd, Minv, dc, dlamM, dqdd, B, stream
        "grid_t2": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _P),
        # consts, q, qd, qdd, v, dv, dqdd, da, df, B, which, gravity, stream
        "grid_t4": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _D, _P),
        # consts, q, qd, v, a, f, lamM, dv, da, df, out, B, which, side_q,
        # cb, gravity, stream
        "grid_t5": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                    _I, _D, _P),
    },
    "md.cu": {
        # consts, q, qd, qdd (or NULL), c, B, gravity, stream
        "grid_md_rnea": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, u, qdd, B, gravity, stream
        "grid_md_fd": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, u, qdd, B, gravity, stream
        "grid_md_aba": (_P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, qdd (or NULL), dq, dqd, B, gravity, stream
        "grid_md_id_grad": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, u, dq, dqd, du, B, gravity, stream
        "grid_md_fd_grad": (_P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
    },
    "md_staged.cu": {
        # consts, q, qd, qdd (or NULL), v, a, f, B, gravity, stream
        "grid_md_vaf": (_P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd (or NULL), u (or NULL), M, qdd (or NULL), B,
        # gravity, stream
        "grid_md_minv": (_P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, q, qd, v, a, f, Minv (or NULL), dq, dqd, B, cb, gravity,
        # stream
        "grid_md_grad_cols": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                              _D, _P),
    },
    "ff.cu": {
        # consts, quat, q, vb, qd, tau, dvb, qdd, B, gravity, stream
        "grid_fb_aba": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
        "grid_fb_fd": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _D, _P),
        # consts, quat, pos, q, vb, qd, tau, offsets, anchors (or NULL), dvb,
        # qdd, lam, B, gravity, alpha, beta, reg, stream
        "grid_stance_fd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _LL, _D, _D, _D, _D, _P),
        # consts, quat, pos, q, vb, qd, tau, mu, push (or NULL), offsets,
        # geoms (or NULL), collision (or NULL), loops (or NULL), ridge,
        # quat2, pos2, q2, vb2, qd2, imp, B, feet, dt, ground_z, gravity,
        # iters, erp, margin, restitution, stream
        "grid_step_ground": (*(_P,) * 20, _LL, _I, _D, _D, _D, _I, _D, _D,
                             _D, _P),
        # ..., imp, heights, B, feet, dt, gravity, iters, erp, margin,
        # restitution, H, W, cell, x0, y0, stream
        "grid_step_ground_terrain": (*(_P,) * 21, _LL, _I, _D, _D, _I, _D,
                                     _D, _D, _I, _I, _D, _D, _D, _P),
    },
    "md_step.cu": {
        # consts, q, qd, tau, mu, offsets, geoms (or NULL), ridge, q2, v2,
        # imp, B, feet, dt, ground_z, gravity, iters, erp, margin,
        # restitution, stream
        "grid_md_step_ground": (*(_P,) * 11, _LL, _I, _D, _D, _D, _I, _D,
                                _D, _D, _P),
    },
}
# the units a library holds by default: single-dof robots, multi-dof robots
_SINGLE_DOF_UNITS = ("fused.cu", "staged.cu", "so.cu")
_MD_UNITS = ("md.cu",)
MD_STAGED_UNIT = "md_staged.cu"
MD_STEP_UNIT = "md_step.cu"
_FF_UNITS = ("ff.cu",)
# joint type → its code in the md unit's GRID_JTYPES macro
_JOINT_CODES = {"revolute": 0, "continuous": 0, "prismatic": 1,
                "spherical": 2, "floating": 3}
_CODE_DOF = (1, 1, 3, 6)


def dense_grads(n: int) -> bool:
    """Whether ∇FD, ∂ID and M⁻¹ run as single-thread kernels (else as the
    staged pipeline) — the one place the routing and the build decide it."""
    return n <= MAX_KERNEL_JOINTS


def dense_hessian(n: int) -> bool:
    """Whether the full Hessian runs as the single-thread kernel (else as n
    staged λᵀ·H calls) — read by its routing and by the build."""
    return n <= MAX_HESSIAN_JOINTS


def dense_hessian_vp(n: int) -> bool:
    """Whether λᵀ·H runs as the single-thread kernel (else as the staged
    pipeline)."""
    return dense_hessian(n) and n <= MAX_HESSIAN_VP_JOINTS


def md_dense_grads(nv: int) -> bool:
    """Whether the multi-dof ∂ID and ∇FD run (and are built) as the
    single-thread kernels of md.cu, else as the staged pipeline of
    md_staged.cu — read by the routing and the build."""
    return nv <= MAX_MD_GRAD_NV


def _widest_block(ncols: int, values_per_col: int,
                  budget: int = _K5_VALUES) -> int:
    """The widest block of ``ncols`` columns whose ∂-tensors fit ``budget``
    values a thread, preferring a width that divides ncols (uniform blocks)
    unless that would waste more than half of it."""
    cb_max = max(1, min(ncols, budget // values_per_col))
    best = max(d for d in range(1, cb_max + 1) if ncols % d == 0)
    return best if best * 2 > cb_max else cb_max


def default_col_block(n: int) -> int:
    """K5's column-block width (dv, da, df: 18·n values a column)."""
    return _widest_block(n, 18 * n)


def minv_col_block(n: int) -> int:
    """K3's column-block width (minv_staged: F and the rows, 7·n values a
    column)."""
    return _widest_block(n, 7 * n)


def so_col_block(n: int) -> int:
    """T5's column-block width: K5's ∂-tensors in dual numbers, 36·n values
    a column."""
    return _widest_block(n, 36 * n)


def md_col_block(n: int, nv: int) -> int:
    """K5md's column-block width over the nv directions (dv, da, df: 18·n
    values a column)."""
    return _widest_block(nv, 18 * n, _MD_K5_VALUES)


# ------------------------------------------------------------------------
# The CTA-tile K5 and K2′ (csrc/tile.cuh): topology tables and tile sizes
# ------------------------------------------------------------------------
def _tree(parents):
    """Each joint's children (descending), depth and ancestors (root
    first); parents precede their children."""
    n = len(parents)
    children = [[] for _ in range(n)]
    depth, anc = [0] * n, [[] for _ in range(n)]
    for i, p in enumerate(parents):
        if p >= 0:
            if p >= i:
                raise ValueError(f"joint {i}'s parent {p} does not precede it")
            children[p].insert(0, i)
            depth[i] = depth[p] + 1
            anc[i] = anc[p] + [p]
    return children, depth, anc


def k5_pattern(parents):
    """K5's packed columns, ascending, joint by joint: the columns where
    ∂v_i and ∂a_i can be nonzero (i's ancestors and i) and those where ∂f_i
    and the rows ∂c_i can be (those and i's subtree)."""
    _, _, anc = _tree(parents)
    n = len(parents)
    sub = [[] for _ in range(n)]
    for i in range(n):
        for a in anc[i]:
            sub[a].append(i)
    dva = [anc[i] + [i] for i in range(n)]
    return dva, [anc[i] + [i] + sub[i] for i in range(n)]


def _flatten(tables: dict):
    """The tables as one int16 list and each one's offset into it."""
    flat, offs = [], {}
    for name, vals in tables.items():
        offs[name] = len(flat)
        flat += [int(v) for v in vals]
    if max(map(abs, flat)) >= 1 << 15:
        raise ValueError("a topology table does not fit int16")
    return flat, offs


def _tile_states(plan: dict, n: int, itemsize: int) -> int:
    """States a CTA: as many as fit SMEM_BYTES beside the robot constants
    and the tables, at most TILE_MAX_STATES; 0 where not one fits."""
    free = SMEM_BYTES - 152 * n * itemsize - _table_bytes(plan)
    return max(0, min(TILE_MAX_STATES, free // (plan["stride"] * itemsize)))


def _table_bytes(plan: dict) -> int:
    return -(-2 * len(plan["flat"]) // 16) * 16


def tile_smem_bytes(plan: dict, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA: constants, tile, tables."""
    return ((152 * n + _tile_states(plan, n, itemsize) * plan["stride"])
            * itemsize + _table_bytes(plan))


def _finish_plan(plan: dict, tables: dict, n: int) -> dict:
    plan["flat"], plan["offs"] = _flatten(tables)
    plan["tables"] = tables
    # an odd stride puts one state's value and the next state's in
    # different shared-memory banks
    plan["stride"] = plan["values"] | 1
    plan["states"] = {dt: _tile_states(plan, n, size)
                      for dt, size in (("f32", 4), ("f64", 8))}
    return plan


def grad_cols_tile_plan(parents, prismatic) -> dict:
    """K5's tile plan. A state's values: X (its two 3×3 blocks, 18n), v, a,
    f, I·v and the q side's seed X_iᵀ·(S_i ×* f_i) (6n each) — with room
    for M⁻¹ (n²) in the finish — then for each side ∂v and ∂a (6 a packed
    ∂v/∂a column) and ∂f (6 a packed ∂f column), where the rows ∂c and the
    outputs (2n²) go in the finish. Tables: the forward items (i, k, ∂v/∂a
    slot, the parent's slot of column k or −1, ∂f slot) in BFS waves from
    the roots; the backward items (p, k, ∂f slot, whether the forward sweep
    wrote it) in waves from the deepest parents, each gathering its
    children in descending order (the plain version's order); the ∂f slot
    of every (joint, column) or −1; each ∂f slot's (joint, column); and
    each column's rows and their ∂f slots, rows ascending (the finish's
    sum)."""
    n = len(parents)
    children, depth, _ = _tree(parents)
    dva, df = k5_pattern(parents)

    def slots(cols):
        out, off = [], 0
        for c in cols:
            out.append({k: off + j for j, k in enumerate(c)})
            off += len(c)
        return out, off

    sv, ndva = slots(dva)
    sf, ndf = slots(df)
    waves = max(depth) + 1
    fw, fw_waves = [], [0]
    for d in range(waves):
        for i in (j for j in range(n) if depth[j] == d):
            p = parents[i]
            for k in dva[i]:
                fw += [i, k, sv[i][k], sv[p][k] if k != i else -1, sf[i][k]]
        fw_waves.append(len(fw) // 5)
    bw, bw_waves = [], [0]
    for d in range(waves - 2, -1, -1):
        for p in (j for j in range(n) if depth[j] == d and children[j]):
            for k in df[p]:
                bw += [p, k, sf[p][k], int(k in sv[p])]
        bw_waves.append(len(bw) // 4)
    tables = {
        "par": parents, "prism": prismatic,
        "fw": fw, "fw_waves": fw_waves, "bw": bw, "bw_waves": bw_waves,
        "ch_start": [0] + list(itertools.accumulate(map(len, children))),
        "ch_list": [c for ch in children for c in ch],
        "df_slot": [sf[c].get(k, -1) for c in range(n) for k in range(n)],
        "df_ik": [x for i in range(n) for k in df[i] for x in (i, k)],
        "col_start": [0] + list(itertools.accumulate(
            sum(c in sf[i] for i in range(n)) for c in range(n))),
        "col_i": [i for c in range(n) for i in range(n) if c in sf[i]],
        "col_d": [sf[i][c] for c in range(n) for i in range(n)
                  if c in sf[i]],
    }
    region = max(48 * n, n * n)
    plan = {"dva": ndva, "df": ndf, "waves": waves, "region": region,
            "values": region + max(6 * (4 * ndva + 2 * ndf),
                                   2 * ndf + 2 * n * n)}
    return _finish_plan(plan, tables, n)


def minv_tile_plan(parents, prismatic) -> dict:
    """K2′'s tile plan. A state's values: X (its two 3×3 blocks, 18n), IC
    (36n; then L⁻¹, n²)
    and M (n²; first sin/cos of q and IC_c·X_c of one wave of children).
    Tables: the CRBA sweep's waves from the deepest joints, each a list of
    children c (and c's place in its wave) and the list of their parents,
    which gather their children in descending order."""
    n = len(parents)
    children, depth, _ = _tree(parents)
    cw, cs, pw, ps, pos = [0], [], [0], [], [0] * n
    for d in range(max(depth), 0, -1):
        wave = [j for j in range(n) if depth[j] == d]
        for w, c in enumerate(wave):
            pos[c] = w
        cs += wave
        cw.append(len(cs))
        ps += sorted({parents[c] for c in wave})
        pw.append(len(ps))
    wide = max([b - a for a, b in zip(cw, cw[1:])], default=0)
    tables = {
        "par": parents, "prism": prismatic, "cw": cw, "c": cs, "pw": pw,
        "p": ps, "pos": pos,
        "ch_start": [0] + list(itertools.accumulate(map(len, children))),
        "ch_list": [c for ch in children for c in ch],
    }
    plan = {"waves": len(cw) - 1, "ic": max(36 * n, n * n),
            "m": max(n * n, 36 * wide, 2 * n)}
    plan["values"] = 18 * n + plan["ic"] + plan["m"]
    return _finish_plan(plan, tables, n)


def _fit_states(stride: int, n: int, itemsize: int, table_bytes: int,
                ctas: int) -> int:
    """States a CTA of ``stride`` values each: as many as fit an SM's shared
    memory over ``ctas`` CTAs beside the robot constants and the tables,
    at most TILE_MAX_STATES; 0 where not one fits."""
    per_cta = min(SMEM_BYTES, SM_SMEM_BYTES // ctas - 1024)
    free = per_cta - 152 * n * itemsize - table_bytes
    return max(0, min(TILE_MAX_STATES, free // (stride * itemsize)))


def rnea_tile_plan(parents, prismatic) -> dict:
    """The RNEA sweeps' tile plan (K1, K4 and ∂ID's vaf; the ∇FD tile's
    sweeps and its M⁻¹ recursion run on the same tables). A state's values:
    X (its two 3×3 blocks, 18n), v, a, f (6n each; sin/cos of q in f's
    rows until X is built), q̇ and q̈ (n each). Tables: the joints in BFS
    waves from the roots (the forward sweeps); the parents in waves from
    the deepest, each gathering its children in descending order (the
    backward sweeps: the plain version's order)."""
    n = len(parents)
    children, depth, _ = _tree(parents)
    waves = max(depth) + 1
    fw, fw_waves = [], [0]
    for d in range(waves):
        fw += [j for j in range(n) if depth[j] == d]
        fw_waves.append(len(fw))
    bw, bw_waves = [], [0]
    for d in range(waves - 2, -1, -1):
        bw += [p for p in range(n) if depth[p] == d and children[p]]
        bw_waves.append(len(bw))
    tables = {
        "par": parents, "prism": prismatic, "fw": fw, "fw_waves": fw_waves,
        "bw": bw, "bw_waves": bw_waves,
        "ch_start": [0] + list(itertools.accumulate(map(len, children))),
        "ch_list": [c for ch in children for c in ch],
    }
    plan = {"waves": waves, "values": 38 * n}
    plan["flat"], plan["offs"] = _flatten(tables)
    plan["tables"] = tables
    plan["stride"] = plan["values"] | 1
    plan["states"] = {dt: _fit_states(plan["stride"], n, size,
                                      _table_bytes(plan), TILE_CTAS)
                      for dt, size in (("f32", 4), ("f64", 8))}
    plan["threads"] = dict(zip(("f32", "f64"), VAF_THREADS))
    return plan


def fd_tile_plan(parents, prismatic) -> dict:
    """The recursion ∇FD's tile plan (n ≤ MAX_KERNEL_JOINTS): K5's region
    A (X, v, a, f, I·v, the q side's backward seed) and region B (the
    ∂-tensors of both sides; first sin/cos of q, then the M⁻¹ recursion's
    IA (36n), F (6n²), U (6n), D⁻¹ (n), Ia·X (36n) and Xᵀ·U (6n): region B
    holds the larger), then M⁻¹ (n²), q̇, u and q̈ (n each) and the q
    side's ∂a seeds (6n: the second sweep sums f while K5's forward sweep
    runs). Its
    tables are K5's (grad_cols_tile_plan) and the sweeps'
    (rnea_tile_plan)."""
    n = len(parents)
    k5 = grad_cols_tile_plan(parents, prismatic)
    rn = rnea_tile_plan(parents, prismatic)
    region_b = max(k5["values"] - k5["region"], 85 * n + 6 * n * n)
    plan = {"region_b": region_b,
            "values": k5["region"] + region_b + n * n + 9 * n}
    plan["stride"] = plan["values"] | 1
    tables = _table_bytes(k5) + _table_bytes(rn)
    plan["states"] = {dt: _fit_states(plan["stride"], n, size, tables,
                                      TILE_CTAS)
                      for dt, size in (("f32", 4), ("f64", 8))}
    plan["threads"] = dict(zip(("f32", "f64"), FD_THREADS))
    plan["table_bytes"] = tables
    return plan


def sweep_smem_bytes(plan: dict, n: int, itemsize: int, dt: str) -> int:
    """Dynamic shared memory of one CTA of the sweep or ∇FD tile:
    constants, tile, tables (the ∇FD tile's: K5's and the sweeps')."""
    tables = plan.get("table_bytes", None)
    tables = _table_bytes(plan) if tables is None else tables
    return ((152 * n + plan["states"][dt] * plan["stride"]) * itemsize
            + tables)


def _tile_macros(tag: str, plan: dict, names) -> list[str]:
    gs = lambda xs: "".join(f"G({x})" for x in xs)
    return [f"-DGRID_{tag}_TABLE=" + gs(plan["flat"]),
            f"-DGRID_{tag}_OFFS=" + gs(plan["offs"][k] for k in plan["tables"]),
            f"-DGRID_{tag}_PLAN=" + gs(plan[k] for k in names)
            + gs(plan["states"][t] for t in ("f32", "f64"))]


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernel libraries of one topology and how they were built."""

    libs: dict             # unit → ctypes.CDLL
    paths: dict            # unit → Path of the .so
    build_seconds: dict    # unit → nvcc seconds (0.0 when reused)
    logs: dict             # unit → nvcc/ptxas output

    def entry(self, name: str, dtype_tag: str):
        lib = self.libs.get(unit_of(name))
        fn = None if lib is None else getattr(lib, f"{name}_{dtype_tag}",
                                              None)
        if fn is None:
            raise NotImplementedError(
                f"{name} is not in this robot's kernel library")
        return fn

    def error_string(self, code: int) -> str:
        lib = next(iter(self.libs.values()))
        return lib.grid_error_string(code).decode()


def unit_of(entry: str) -> str:
    """The source unit that exports ``entry``."""
    for unit, sigs in _UNITS.items():
        if entry in sigs:
            return unit
    raise KeyError(entry)


_LOCK = threading.Lock()
_KEY_LOCKS: dict[tuple, threading.Lock] = {}
_LOADED: dict[tuple, KernelLibrary] = {}


def topology_key(model, links=None, pairs=None) -> tuple:
    """What a kernel library is specialised on: joint count, parents and
    which joints are prismatic; for a multi-dof model (one with
    ``v_slices``) the tag ``"md"`` and every joint's type, which fix its
    coordinate slices (a ball root and a free root under the same parents
    build different libraries), and with contact ``links`` those too (the
    ground step's library: feet, then each ground-geom contact's link); for
    a free flyer (one with ``I_base``) the tag ``"ff"``, its arm's key and
    the contact ``links`` (empty: the ABA and mass-matrix kernels; else the
    stance and ground-step kernels of those links — feet, then each geom
    contact's link, −1 for the base —, whose rows are zero outside each
    link's ancestors), and for a ground step with collision contacts or
    loop closures ``pairs`` = (each collision contact's two links — −2 for
    an obstacle —, each closure's (a, b) — b = −1 for a world pin): these
    fix the rows' columns; the geometry is a run-time argument."""
    parents = tuple(model.topology.parents)
    if hasattr(model, "v_slices"):
        key = ("md", model.n, parents,
               tuple(_JOINT_CODES[t] for t in model.joint_types))
        return key + (tuple(int(l) for l in links),) if links else key
    prism = tuple(int(t == "prismatic") for t in model.joint_types)
    if hasattr(model, "I_base"):
        key = ("ff", model.n, parents, prism,
               tuple(int(l) for l in (links or ())))
        if pairs and any(pairs):
            key += tuple(tuple((int(a), int(b)) for a, b in p)
                         for p in pairs)
        return key
    return (model.n, parents, prism)


def _md_nv(codes) -> int:
    return sum(_CODE_DOF[c] for c in codes)


def _units(key: tuple) -> tuple:
    """The units a topology builds by default."""
    if key[0] == "ff":
        return _FF_UNITS
    if key[0] != "md":
        return _SINGLE_DOF_UNITS
    if len(key) == 5:
        return (MD_STEP_UNIT,)
    staged = () if md_dense_grads(_md_nv(key[3])) else (MD_STAGED_UNIT,)
    return _MD_UNITS + staged


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def _macros(key: tuple) -> list[str]:
    if key[0] == "ff":
        _, n, parents, prism, links = key[:5]
        coll, loops = key[5:] if len(key) == 7 else ((), ())
        gs = lambda xs: "".join(f"G({x})" for x in xs)
        out = [
            f"-DGRID_N={n}",
            "-DGRID_PARENTS=" + gs(parents),
            "-DGRID_PRISMATIC=" + gs(prism),
            f"-DGRID_FF_K={len(links)}",
        ] + (["-DGRID_FF_LINKS=" + gs(links)] if links else [])
        for tag, rows in (("C", coll), ("L", loops)):
            if rows:
                out += [f"-DGRID_FF_K{tag}={len(rows)}" if tag == "C"
                        else f"-DGRID_FF_L={len(rows)}",
                        f"-DGRID_FF_{tag}A=" + gs(a for a, _ in rows),
                        f"-DGRID_FF_{tag}B=" + gs(b for _, b in rows)]
        return out
    if key[0] == "md":
        _, n, parents, codes = key[:4]
        nv = _md_nv(codes)
        links = key[4] if len(key) == 5 else ()
        return [
            f"-DGRID_N={n}",
            "-DGRID_PARENTS=" + "".join(f"G({p})" for p in parents),
            "-DGRID_PRISMATIC=" + "".join(f"G({int(c == 1)})" for c in codes),
            "-DGRID_JTYPES=" + "".join(f"G({c})" for c in codes),
            f"-DGRID_MD_GRADS={int(md_dense_grads(nv))}",
            f"-DGRID_MD_CB={md_col_block(n, nv)}",
        ] + ([f"-DGRID_MD_K={len(links)}",
              "-DGRID_MD_LINKS=" + "".join(f"G({l})" for l in links)]
             if links else [])
    n, parents, prism = key
    return [
        f"-DGRID_N={n}",
        # nvcc splits -D values at commas: lists go as G(a)G(b)...
        "-DGRID_PARENTS=" + "".join(f"G({p})" for p in parents),
        "-DGRID_PRISMATIC=" + "".join(f"G({p})" for p in prism),
        f"-DGRID_DENSE_GRADS={int(dense_grads(n))}",
        f"-DGRID_CB={default_col_block(n)}",
        f"-DGRID_MINV_CB={minv_col_block(n)}",
        f"-DGRID_DENSE_HESSIAN={int(dense_hessian(n))}",
        f"-DGRID_SO_CB={so_col_block(n)}",
        *_tile_macros("K5", grad_cols_tile_plan(parents, prism),
                      ("dva", "df", "waves", "region", "stride")),
        *_tile_macros("K2", minv_tile_plan(parents, prism),
                      ("waves", "ic", "m", "stride")),
        *_sweep_macros(parents, prism),
    ]


def _sweep_macros(parents, prism) -> list[str]:
    """The sweep tile's tables and plan, and the ∇FD tile's plan (its
    tables are K5's and the sweeps')."""
    gs = lambda xs: "".join(f"G({x})" for x in xs)
    rn, fd = rnea_tile_plan(parents, prism), fd_tile_plan(parents, prism)

    def sized(plan):
        return gs(plan[d][t] for d in ("states", "threads")
                  for t in ("f32", "f64"))
    return ["-DGRID_RN_TABLE=" + gs(rn["flat"]),
            "-DGRID_RN_OFFS=" + gs(rn["offs"][k] for k in rn["tables"]),
            "-DGRID_RN_PLAN=" + gs((rn["waves"], rn["stride"])) + sized(rn),
            "-DGRID_FD_PLAN=" + gs((fd["region_b"], fd["stride"]))
            + sized(fd), f"-DGRID_TILE_CTAS={TILE_CTAS}"]


def _digest(key: tuple) -> str:
    h = hashlib.sha256(repr((_macros(key), UNIT_FLAGS)).encode())
    for name in _HEADERS + tuple(_UNITS):
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(key: tuple, outs: dict) -> tuple[dict, dict]:
    """Run one nvcc per unit, all at once; returns (seconds, logs)."""
    macros = _macros(key)
    procs = {}
    for unit, out in outs.items():
        # build under a private name, then rename: concurrent builds never
        # load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *ARCH_FLAGS, "-O3", "-std=c++17", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *UNIT_FLAGS.get(unit, ()), *macros, "-o", str(tmp),
               str(_CSRC / unit)]
        procs[unit] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds, logs, failed = {}, {}, []
    for unit, (cmd, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[unit] = time.perf_counter() - t0
        logs[unit] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{outs[unit].name}:\n{' '.join(cmd)}\n{log}")
            continue
        outs[unit].with_suffix(".log").write_text(log)
        os.replace(tmp, outs[unit])
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds, logs


def _load(unit: str, so: Path, n: int) -> ctypes.CDLL:
    """Load a library and bind the entries it exports (one built past
    ``MAX_KERNEL_JOINTS``, or ``MAX_MD_GRAD_NV``, has no single-thread
    gradient entries)."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _UNITS[unit].items():
        for tag in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{tag}", None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    lib.grid_num_joints.argtypes = ()
    lib.grid_num_joints.restype = ctypes.c_int
    lib.grid_error_string.argtypes = (ctypes.c_int,)
    lib.grid_error_string.restype = ctypes.c_char_p
    if lib.grid_num_joints() != n:
        raise RuntimeError(f"{so} was built for {lib.grid_num_joints()} "
                           f"joints, not {n}")
    return lib


def library(model, units=None, links=None, pairs=None) -> KernelLibrary:
    """The kernel libraries for ``model``'s topology (a ``RobotModel``'s,
    a ``MultiDofModel``'s or a ``FreeFlyerModel``'s, with its contact
    ``links`` for the stance kernel, and a ground step's collision and loop
    ``pairs``): the units it builds by default, or those named, each built
    (all at once) if it is not yet. Different topologies build
    concurrently."""
    key = topology_key(model, links, pairs)
    want = _units(key) if units is None else tuple(units)
    with _LOCK:
        lib = _LOADED.setdefault(key, KernelLibrary({}, {}, {}, {}))
        if all(u in lib.libs for u in want):
            return lib
        key_lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with key_lock:
        todo = [u for u in want if u not in lib.libs]
        if not todo:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"grid_n{model.n}_{_digest(key)}"
        outs = {u: BUILD_DIR / f"{stem}_{Path(u).stem}.so" for u in todo}
        missing = {u: so for u, so in outs.items() if not so.exists()}
        seconds, logs = _compile(key, missing) if missing else ({}, {})
        for u, so in outs.items():
            if u not in missing:
                seconds[u], logs[u] = 0.0, so.with_suffix(".log").read_text()
        libs = {u: _load(u, so, model.n) for u, so in outs.items()}
        with _LOCK:
            lib.paths.update(outs)
            lib.build_seconds.update(seconds)
            lib.logs.update(logs)
            lib.libs.update(libs)
        return lib
