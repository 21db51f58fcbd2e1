"""Loop-closure constraints of a free flyer, batch last.

The port's counterpart of the free-flyer half of
``gridcodegenerator_tpu/ops/loops.py``. A tree engine closes a kinematic
loop (a four-bar linkage, a parallel leg) by cutting it at a point and
restoring the cut as a bilateral relative point constraint between the two
faces, three rows a cut:

    x_a(q) − x_b(q) = 0,    J_rel = J_a − J_b,

and a pair with ``b = −1`` pins link a's point to the world anchor
``offsets_b``. The ground stepper's ``loops=`` solves these rows after its
friction cones, in the same projected Gauss–Seidel sweep
(``kernels/contact_fused._loop_rows_s``, the rows' one copy).

Here: the pair checks with the JAX package's messages
(:func:`_check_pairs`, :func:`_check_fb_pairs`), the world-frame gap
(:func:`fb_loop_gap`) and the rows (:func:`_fb_loop_rows_bl`), on
batch-last tensors (the JAX package's ``fb_loop_gap`` takes one state;
``jax.vmap`` of it is this). The fixed-base loop entries
(``loop_fd_batched``, ``loop_step_batched``) with ``transmission_rows``,
the single-state free-flyer functions (``fb_loop_jacobian``,
``fb_loop_bias``, ``fb_loop_forward_dynamics``, ``fb_loop_fd_batched``)
and the weld rows wait for ROADMAP Queue 1, 'The rest of kinematics and
contact'.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_pairs(n_links, pairs, offsets_a, offsets_b):
    """Fail fast on a malformed loop set (the JAX package's messages): at
    least one pair, a in [0, n), b in [−1, n) (−1 the world), a ≠ b, and
    both offsets (k, 3). Returns the pairs as a tuple of tuples."""
    pairs = tuple(tuple(p) for p in pairs)
    if not pairs:
        raise ValueError("loop set is empty: pass at least one (a, b) pair")
    for a, b in pairs:
        if not (0 <= int(a) < n_links):
            raise ValueError(
                f"loop link a={a} out of range [0, {n_links})")
        if not (-1 <= int(b) < n_links):
            raise ValueError(
                f"loop link b={b} out of range [-1, {n_links}) "
                "(-1 = world anchor)")
        if int(a) == int(b):
            raise ValueError(f"loop pair ({a}, {b}) pins a link to itself")
    k = len(pairs)
    for name, off in (("offsets_a", offsets_a), ("offsets_b", offsets_b)):
        shp = tuple(np.shape(off))
        if shp != (k, 3):
            raise ValueError(f"{name} must be ({k}, 3), got {shp}")
    return pairs


def _check_fb_pairs(n_links, pairs, offsets_a, offsets_b):
    return _check_pairs(n_links, pairs, offsets_a, offsets_b)


def _loop_rows_dense(ffm, quat_bl, pos_bl, q_bl, pairs, oa, ob):
    """(J (3k, 6+n, B), x_a list, x_b list, gaps (3k,B)) of the closures,
    from the stepper's rows (``kernels/contact_fused._loop_rows_s``)."""
    from .kernels import contact_fused as cf

    ls = cf.loops_static(ffm.n, (pairs, oa, ob))
    X = cf.blops.joint_transforms_bl(ffm.arm, q_bl)
    rows, gaps, xas, xbs = cf._loop_rows_s(ffm, X, cf._quat_rot_s(quat_bl),
                                           pos_bl, ls)
    return (cf._dense_rows(rows, 6 + ffm.n, q_bl[0:1]), xas, xbs,
            torch.cat(gaps))


def _fb_loop_rows_bl(ffm, quat_bl, q_bl, pairs, oa, ob):
    """The closures' rows over [ω_b; v_b; q̇], batch last: quat (4,B), q
    (n,B) → (J (3k, 6+n, B), x_a list, x_b list of base-frame points,
    ``x_b[i] is None`` for a world pin). A link↔link pair has zero base
    linear columns (both points ride the same base) and angular columns
    R·(e_j × (x_a − x_b))."""
    return _loop_rows_dense(ffm, quat_bl, torch.zeros_like(q_bl[:1])
                            .expand(3, -1), q_bl, pairs, oa, ob)[:3]


def fb_loop_gap(ffm, quat_bl, pos_bl, q_bl, pairs, offsets_a, offsets_b):
    """The closures' world-frame gaps (3k,B), batch last: quat (4,B), pos
    (3,B), q (n,B). A link↔link pair's gap is R·(x_a − x_b) (the base
    position cancels); a world pin's pos + R·x_a − anchor."""
    return _loop_rows_dense(ffm, quat_bl, pos_bl, q_bl, pairs, offsets_a,
                            offsets_b)[3]
