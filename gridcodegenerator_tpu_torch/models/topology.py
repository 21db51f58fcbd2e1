"""Kinematic-tree topology: the static structure of a robot.

A copy of ``gridcodegenerator_tpu/models/topology.py`` (plain NumPy): the
JAX package's ``__init__`` imports jax, so the port carries its own copy.

This replaces the reference's external ``URDFParser``
robot-object topology queries (API contract surveyed from call sites across
the reference — e.g. ``get_parent_id_array`` / ``get_ids_by_bfs_level`` /
``get_ancestors_by_id`` / ``get_subtree_by_id`` usage in
``algorithms/_inverse_dynamics.py:35,95`` and
``helpers/_topology_helpers.py:193-215``).

Everything in this module is plain Python / NumPy and **hashable** so that a
``Topology`` can live in the static (aux) part of a JAX pytree: the dynamics
algorithms unroll their per-joint recursions over this structure at trace
time, exactly as the reference unrolls them at CUDA-emission time
(``GRiDCodeGenerator.py:241-310``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Topology:
    """Static structure of a kinematic tree with single-dof joints.

    Joints are numbered ``0..n-1`` in topological order (every joint's parent
    has a smaller index, or ``-1`` meaning the fixed base). ``parents[i]`` is
    the joint index of joint i's parent.
    """

    parents: tuple[int, ...]
    joint_names: tuple[str, ...] = ()
    link_names: tuple[str, ...] = ()

    def __post_init__(self):
        for i, p in enumerate(self.parents):
            if not (-1 <= p < i):
                raise ValueError(
                    f"parents must be topologically ordered; joint {i} has parent {p}"
                )

    # ------------------------------------------------------------------ core
    @property
    def n(self) -> int:
        """Number of single-dof joints (== num positions == num velocities)."""
        return len(self.parents)

    @functools.cached_property
    def depths(self) -> tuple[int, ...]:
        """Tree depth of every joint (the reference's "bfs level")."""
        d = []
        for i, p in enumerate(self.parents):
            d.append(0 if p == -1 else d[p] + 1)
        return tuple(d)

    @property
    def max_depth(self) -> int:
        return max(self.depths)

    @functools.cached_property
    def levels(self) -> tuple[tuple[int, ...], ...]:
        """Joint ids grouped by depth — the BFS waves of the reference
        (``get_ids_by_bfs_level``). ``levels[k]`` can be processed in
        parallel once ``levels[k-1]`` is done."""
        out: list[list[int]] = [[] for _ in range(self.max_depth + 1)]
        for i, d in enumerate(self.depths):
            out[d].append(i)
        return tuple(tuple(l) for l in out)

    @property
    def max_level_width(self) -> int:
        return max(len(l) for l in self.levels)

    @functools.cached_property
    def ancestors(self) -> tuple[tuple[int, ...], ...]:
        """``ancestors[i]``: strict ancestors of joint i, root-first.

        Matches the reference contract (self excluded) used by
        ``get_ancestors_by_id``.
        """
        out: list[tuple[int, ...]] = []
        for i, p in enumerate(self.parents):
            out.append(() if p == -1 else out[p] + (p,))
        return tuple(out)

    @functools.cached_property
    def subtrees(self) -> tuple[tuple[int, ...], ...]:
        """``subtrees[i]``: joint i and all its descendants, ascending.

        Matches the reference contract (self included) used by
        ``get_subtree_by_id``.
        """
        subs: list[list[int]] = [[i] for i in range(self.n)]
        for i in range(self.n - 1, -1, -1):
            p = self.parents[i]
            if p != -1:
                subs[p].extend(subs[i])
        return tuple(tuple(sorted(s)) for s in subs)

    @functools.cached_property
    def children(self) -> tuple[tuple[int, ...], ...]:
        out: list[list[int]] = [[] for _ in range(self.n)]
        for i, p in enumerate(self.parents):
            if p != -1:
                out[p].append(i)
        return tuple(tuple(c) for c in out)

    @property
    def is_serial_chain(self) -> bool:
        """True iff every joint's parent is the previous joint
        (reference: ``is_serial_chain``, ``_topology_helpers.py:74``)."""
        return all(p == i - 1 for i, p in enumerate(self.parents))

    def level_has_repeated_parents(self, level: int) -> bool:
        """Whether a BFS wave contains siblings (two joints sharing a parent)
        — where the reference emits ``atomicAdd`` instead of ``+=``
        (``algorithms/_inverse_dynamics.py:276-282``). In the
        functional design this decides nothing for correctness (we always
        scatter-add), but it is exposed for tests and introspection. The base
        (-1) is not a real accumulation target and is ignored."""
        ps = [self.parents[i] for i in self.levels[level] if self.parents[i] != -1]
        return len(ps) != len(set(ps))

    # -------------------------------------------------------- sparsity masks
    @functools.cached_property
    def ancestor_mask(self) -> np.ndarray:
        """(n, n) bool; ``[i, j]`` True iff j is a strict ancestor of i."""
        m = np.zeros((self.n, self.n), dtype=bool)
        for i, anc in enumerate(self.ancestors):
            m[i, list(anc)] = True
        return m

    @functools.cached_property
    def ancestor_or_self_mask(self) -> np.ndarray:
        return self.ancestor_mask | np.eye(self.n, dtype=bool)

    @functools.cached_property
    def subtree_mask(self) -> np.ndarray:
        """(n, n) bool; ``[i, j]`` True iff j is in the subtree of i
        (self included)."""
        m = np.zeros((self.n, self.n), dtype=bool)
        for i, sub in enumerate(self.subtrees):
            m[i, list(sub)] = True
        return m

    @functools.cached_property
    def dc_mask(self) -> np.ndarray:
        """(n, n) bool; nonzero-pattern of dc/dq and dc/dq̇: ancestors ∪
        subtree (reference sparsity, ``_inverse_dynamics_gradient.py:592-635``)."""
        return self.ancestor_mask | self.subtree_mask

    @property
    def total_ancestor_count(self) -> int:
        """Σ_i |ancestors(i)| — the reference's ``get_total_ancestor_count``
        used to size compressed gradient storage
        (``_topology_helpers.py:193-215``)."""
        return sum(len(a) for a in self.ancestors)

    @property
    def total_subtree_count(self) -> int:
        return sum(len(s) for s in self.subtrees)


def topology_from_parents(parents, joint_names=(), link_names=()) -> Topology:
    return Topology(tuple(int(p) for p in parents), tuple(joint_names), tuple(link_names))
