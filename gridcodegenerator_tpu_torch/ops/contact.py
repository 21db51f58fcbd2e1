"""Constrained (contact) forward dynamics of a free flyer, batched.

The port's counterpart of ``gridcodegenerator_tpu/ops/contact.py``'s
stance FD: k points of the robot pinned to world anchors (stance feet),

    M·[v̇b; q̈] = [−f_b; τ − c_j] + Jᵀλ,    J·[v̇b; q̈] + J̇·[vb; q̇] = a*,

solved by elimination through the Delassus operator G = J·M⁻¹·Jᵀ, with
the Baumgarte acceleration a* = −2α·J·[vb; q̇] − β²·(x − anchor).
:func:`fb_constrained_fd_batched` runs the stance kernel
(``stance_fd_fused``, :mod:`.kernels.contact_fused`) on CUDA tensors and
its plain version on CPU tensors. The JAX package's second batch-last
pipeline of the same function (``_fb_bias_bl``, ``_fb_mass_matrix_bl``,
``chol_*_bl``, ``_fb_contact_rows_bl``) is not copied: the tests hold the
port to it directly. The fixed-base pins, the single-state functions and
the ground stepper wait for their ROADMAP items.
"""

from __future__ import annotations

import numpy as np

from ..api import _check_impl, _cols, _unflat
from .freeflyer import FreeFlyerModel, _check_ff_states
from .kernels import contact_fused as _cf


def _check_contacts(n_links_valid, links, offsets):
    """Fail fast on malformed contact geometry: a non-empty tuple of links
    within range, and offsets shaped (k, 3)."""
    links = tuple(links)
    if not links:
        raise ValueError("contact set is empty: pass at least one link")
    for l in links:
        if not (0 <= int(l) < n_links_valid):
            raise ValueError(
                f"contact link index {l} out of range [0, {n_links_valid})")
    shp = np.shape(offsets)
    if shp != (len(links), 3):
        raise ValueError(
            f"offsets must be ({len(links)}, 3) body-frame points, got {shp}")


def fb_constrained_fd_batched(ffm: FreeFlyerModel, quat, pos, q, vb, qd, tau,
                              links, offsets, anchors=None, gravity=-9.81,
                              baumgarte=(0.0, 0.0), reg=0.0, impl="auto"):
    """Stance FD over leading batch axes: quat (..., 4), pos (..., 3), q,
    q̇, τ (..., n), vb (..., 6) → (v̇b (..., 6), q̈ (..., n), λ (..., 3k)).

    ``links`` (k link indices) and ``offsets`` (k, 3) place the contact
    points in their links' frames; ``anchors`` (k, 3) are the world pins
    (None: each point's current position, a pure velocity constraint);
    ``baumgarte`` = (α, β); ``reg`` is a ridge on the Delassus operator for
    redundant contact sets. λ is the world-frame force on the robot at each
    point. ``impl``: ``"auto"``, or ``"cuda"`` (CUDA tensors only)."""
    _check_contacts(ffm.n, links, offsets)
    names = ("quat", "pos", "q", "vb", "qd", "tau")
    states = (quat, pos, q, vb, qd, tau)
    _check_ff_states(ffm, states, names)
    _check_impl(impl, q)
    dvb, qdd, lam = _cf.stance_fd_fused(
        ffm, *(_cols(x) for x in states), links,
        np.asarray(offsets, np.float64),
        None if anchors is None else np.asarray(anchors, np.float64),
        gravity, baumgarte, reg)
    batch = tuple(q.shape[:-1])
    return _unflat(dvb, batch), _unflat(qdd, batch), _unflat(lam, batch)
