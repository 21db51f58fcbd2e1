"""Heightfield terrain for the ground stepper.

The port's counterpart of ``gridcodegenerator_tpu/ops/terrain.py``: the
ground generalised from ``z = ground_z`` to a bilinear heightfield
``z = h(x, y)``. Height, gradient and contact frame are closed-form in the
node heights and the query point, elementwise in the query (so the
stepper's batch-last (1, B) slices pass straight through; the only
non-elementwise work is a gather of four nodes a query). The surface is
bilinear in each cell and continues the edge cell's form outside the grid
(linear extrapolation), so h and ∇h stay consistent everywhere.

Layout: ``heights[i, j]`` is the node at world ``(x0 + i·cell, y0 +
j·cell)`` — x-major, as ``meshgrid(..., indexing='ij')``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..models.robot import _require_device


@dataclass(frozen=True, eq=False)
class Terrain:
    """A square-cell bilinear heightfield: ``heights`` (Hx, Wy) node
    heights, ``origin`` (2,) the world (x, y) of node [0, 0], both on one
    device in one dtype, and ``cell`` the node spacing in metres. Treated
    as immutable: the stepper keeps one copy of the grid a device and
    dtype (:func:`placed`), which an in-place edit renews."""

    heights: torch.Tensor
    origin: torch.Tensor
    cell: float


def make_terrain(heights, origin=(0.0, 0.0), cell: float = 0.1,
                 dtype=torch.float32, device="cuda") -> Terrain:
    """A :class:`Terrain` on ``device`` (the card unless the caller names
    another) in ``dtype``."""
    device = _require_device(device)
    h = (heights.to(device=device, dtype=dtype)
         if isinstance(heights, torch.Tensor)
         else torch.tensor(np.array(heights), dtype=dtype, device=device))
    if h.dim() != 2 or h.shape[0] < 2 or h.shape[1] < 2:
        raise ValueError(
            f"heights must be (Hx>=2, Wy>=2), got {tuple(h.shape)}")
    return Terrain(h.contiguous(), torch.tensor(
        np.array(origin, dtype=np.float64), dtype=dtype, device=device),
        float(cell))


_COPIES: "weakref.WeakKeyDictionary[Terrain, dict]" = (
    weakref.WeakKeyDictionary())


def placed(terr: Terrain, device, dtype):
    """``terr`` on ``device`` in ``dtype`` with contiguous heights, and its
    origin (x0, y0) as Python floats of that dtype: made once a device and
    dtype and kept while ``terr`` lives (renewed after an in-place edit of
    its heights or origin), so a loop of steps makes no copy and no
    device-to-host read."""
    if terr.heights.dim() != 2 or min(terr.heights.shape) < 2:
        raise ValueError(f"heights must be (Hx>=2, Wy>=2), got "
                         f"{tuple(terr.heights.shape)}")
    key = (torch.device(device), dtype)
    version = (terr.heights._version, terr.origin._version)
    copies = _COPIES.setdefault(terr, {})
    hit = copies.get(key)
    if hit is None or hit[0] != version:
        t = Terrain(terr.heights.to(device=key[0], dtype=dtype).contiguous(),
                    terr.origin.to(device=key[0], dtype=dtype), terr.cell)
        hit = (version, (t, *t.origin.tolist()))
        copies[key] = hit
    return hit[1]


# -------------------------------------------------------------------------
# height, gradient and frames (elementwise in the query)
# -------------------------------------------------------------------------
def cell_index(terr: Terrain, x, y):
    """The query's in-grid coordinates (u, v) = ((x, y) − origin)/cell and
    the clipped cell indices (iu, iv) ∈ [0, Hx−2] × [0, Wy−2], as floats."""
    H, W = terr.heights.shape
    u = (x - terr.origin[0]) / terr.cell
    v = (y - terr.origin[1]) / terr.cell
    iu = torch.clamp(torch.floor(u), 0, H - 2)
    iv = torch.clamp(torch.floor(v), 0, W - 2)
    return u, v, iu, iv


def terrain_height_grad(terr: Terrain, x, y):
    """(h, ∂h/∂x, ∂h/∂y) of the bilinear surface at world (x, y).

    Inside a cell h = (1−fu)(1−fv)·h00 + fu(1−fv)·h10 + (1−fu)fv·h01 +
    fu·fv·h11 with fu, fv the in-cell fractions; outside the grid the
    nearest edge cell's form continues (fu, fv run past [0, 1])."""
    W = terr.heights.shape[1]
    u, v, iu, iv = cell_index(terr, x, y)
    fu = u - iu
    fv = v - iv
    flat = terr.heights.reshape(-1)
    idx = (iu * W + iv).long()
    h00 = flat[idx]
    h10 = flat[idx + W]
    h01 = flat[idx + 1]
    h11 = flat[idx + W + 1]
    h = ((1 - fu) * (1 - fv) * h00 + fu * (1 - fv) * h10
         + (1 - fu) * fv * h01 + fu * fv * h11)
    hx = ((1 - fv) * (h10 - h00) + fv * (h11 - h01)) / terr.cell
    hy = ((1 - fu) * (h01 - h00) + fu * (h11 - h10)) / terr.cell
    return h, hx, hy


def terrain_surface(terr: Terrain, x, y):
    """(h, n) at world (x, y): the height and the unit upward normal n =
    [−hx, −hy, 1]/‖·‖, stacked on a leading axis of 3."""
    h, hx, hy = terrain_height_grad(terr, x, y)
    inv = 1.0 / torch.sqrt(hx * hx + hy * hy + 1.0)
    return h, torch.stack([-hx * inv, -hy * inv, inv])


def contact_frame(nrm):
    """The right-handed contact frame rows C = [t1; t2; n] from a unit
    normal with n_z > 0 (always so on a heightfield): t1 ∝ e_y × n = [n_z,
    0, −n_x], t2 = n × t1. ``nrm`` is (3, ...); returns (3, 3, ...) with
    C[r] the r-th row — the identity for n = +e_z (the flat stepper's
    rows)."""
    nx, ny, nz = nrm[0], nrm[1], nrm[2]
    it = 1.0 / torch.sqrt(nz * nz + nx * nx)
    t1 = torch.stack([nz * it, torch.zeros_like(nz), -nx * it])
    t2 = torch.stack([ny * t1[2] - nz * t1[1],
                      nz * t1[0] - nx * t1[2],
                      nx * t1[1] - ny * t1[0]])
    return torch.stack([t1, t2, nrm])


# -------------------------------------------------------------------------
# constructors
# -------------------------------------------------------------------------
def _grid(extent: float, cell: float):
    """Node axis over [−extent, extent] and the spacing the nodes really
    have (the requested cell rounded so that the span divides evenly)."""
    m = max(2, int(round(2 * extent / cell))) + 1
    ax = np.linspace(-extent, extent, m)
    return ax, 2 * extent / (m - 1)


def flat_terrain(height: float = 0.0, extent: float = 4.0,
                 cell: float = 0.5, dtype=torch.float32,
                 device="cuda") -> Terrain:
    ax, cell = _grid(extent, cell)
    m = ax.shape[0]
    return make_terrain(np.full((m, m), height), (-extent, -extent), cell,
                        dtype, device)


def slope_terrain(grade_x: float = 0.2, grade_y: float = 0.0,
                  extent: float = 4.0, cell: float = 0.5,
                  dtype=torch.float32, device="cuda") -> Terrain:
    """The inclined plane z = grade_x·x + grade_y·y (exact on the bilinear
    surface, so the normal is exact everywhere)."""
    ax, cell = _grid(extent, cell)
    X, Y = np.meshgrid(ax, ax, indexing="ij")
    return make_terrain(grade_x * X + grade_y * Y, (-extent, -extent),
                        cell, dtype, device)


def bumpy_terrain(amp: float = 0.05, wavelength: float = 0.8,
                  extent: float = 4.0, cell: float = 0.1, seed: int = 0,
                  rough: float = 0.0, dtype=torch.float32,
                  device="cuda") -> Terrain:
    """Sinusoidal egg-carton bumps plus optional uniform node noise (numpy,
    from ``seed``)."""
    ax, cell = _grid(extent, cell)
    X, Y = np.meshgrid(ax, ax, indexing="ij")
    w = 2 * np.pi / wavelength
    h = amp * np.sin(w * X) * np.sin(w * Y)
    if rough > 0.0:
        h = h + np.random.default_rng(seed).uniform(-rough, rough, h.shape)
    return make_terrain(h, (-extent, -extent), cell, dtype, device)
