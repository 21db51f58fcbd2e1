"""Golden NumPy dynamics model (float64, CPU).

A copy of ``gridcodegenerator_tpu/utils/golden.py``, so a host without jax
(the GPU machine) can score the port against the float64 oracle.

The numerical oracle — the role the reference's embedded
NumPy implementation plays (``_test.py``; strategy documented
in SURVEY.md §4). Semantics match the reference exactly, including the two
parity nuances SURVEY.md §2 flags:

* **viscous joint damping** is applied to the torque output and to the
  diagonal of ∂c/∂q̇ (reference ``_test.py:103-105,486`` — present in the
  golden model but *missing* from the generated CUDA; we implement the more
  complete semantics and expose damping per joint),
* **gravity convention**: the fictitious base acceleration is
  ``a_base = [0,0,0,0,0,-GRAVITY]`` with default ``GRAVITY = -9.81``
  (reference ``_test.py:13-14``).

Beyond the reference's four test functions this module adds *independent*
validators used by the test suite: forward kinematics, total mechanical
energy, and CRBA (a second, unrelated mass-matrix algorithm to cross-check
the analytic M⁻¹ recursion).

Everything here is deliberately simple, loop-based float64 NumPy — the
readable source of truth the fast JAX/Pallas paths are tested against.
"""

from __future__ import annotations

import numpy as np

from ..models.urdf import RobotDescription, rpy_to_matrix, skew


# --------------------------------------------------------------------------
# Spatial operators ([angular; linear] ordering, Featherstone)
# --------------------------------------------------------------------------
def crm(v: np.ndarray) -> np.ndarray:
    """Motion cross-product matrix v× (reference ``mx``, ``_test.py:610``)."""
    w, u = v[:3], v[3:]
    M = np.zeros((6, 6))
    M[:3, :3] = skew(w)
    M[3:, 3:] = skew(w)
    M[3:, :3] = skew(u)
    return M


def crf(v: np.ndarray) -> np.ndarray:
    """Force cross-product matrix v×* = −(v×)ᵀ (reference ``fx``,
    ``_test.py:616-647``)."""
    return -crm(v).T


class GoldenDynamics:
    """Float64 reference dynamics for one robot."""

    def __init__(self, desc: RobotDescription):
        self.desc = desc
        self.topo = desc.topology
        self.n = desc.n
        # constant parse-time data
        self._R_origin = np.stack([rpy_to_matrix(r) for r in desc.origin_rpy])
        self._xyz = np.asarray(desc.origin_xyz, dtype=np.float64)
        self._axis = np.asarray(desc.axis, dtype=np.float64)
        self._prism = np.array([t == "prismatic" for t in desc.joint_types])
        self.inertias = np.asarray(desc.inertia, dtype=np.float64)
        self.damping = np.asarray(desc.damping, dtype=np.float64)
        self.armature = (np.zeros(self.n) if desc.armature is None
                         else np.asarray(desc.armature, dtype=np.float64))
        self.S = np.zeros((self.n, 6))
        for i in range(self.n):
            if self._prism[i]:
                self.S[i, 3:] = self._axis[i]
            else:
                self.S[i, :3] = self._axis[i]

    # ---------------------------------------------------------------- frames
    def _joint_pose(self, i: int, qi: float) -> tuple[np.ndarray, np.ndarray]:
        """Pose (R, p) of joint i's child frame in its parent link frame.

        Computed by direct rotation composition — an independent derivation
        from the affine (Xb, Xs, Xc) form the fast paths use, so the two
        cross-validate each other.
        """
        a = self._axis[i]
        if self._prism[i]:
            return self._R_origin[i], self._xyz[i] + self._R_origin[i] @ (a * qi)
        K = skew(a)
        R_j = np.eye(3) + np.sin(qi) * K + (1.0 - np.cos(qi)) * (K @ K)
        return self._R_origin[i] @ R_j, self._xyz[i]

    def xmat(self, i: int, qi: float) -> np.ndarray:
        """Motion transform X_i (child ← parent coordinates) — the golden
        analog of the reference's ``get_Xmat_Func_by_id(i)(q)``."""
        R, p = self._joint_pose(i, qi)
        E = R.T
        X = np.zeros((6, 6))
        X[:3, :3] = E
        X[3:, 3:] = E
        X[3:, :3] = -E @ skew(p)
        return X

    def xmats(self, q: np.ndarray) -> np.ndarray:
        return np.stack([self.xmat(i, q[i]) for i in range(self.n)])

    # ----------------------------------------------------------------- RNEA
    def rnea_fpass(self, q, qd, qdd=None, gravity=-9.81):
        """Forward pass of RNEA → (v, a, f), each (n, 6).

        Reference semantics: ``_test.py:5-76`` (``test_rnea_fpass``).
        """
        n = self.n
        X = self.xmats(q)
        a_base = np.zeros(6)
        a_base[5] = -gravity
        v = np.zeros((n, 6))
        a = np.zeros((n, 6))
        for i in range(n):
            p = self.topo.parents[i]
            vp = v[p] if p >= 0 else np.zeros(6)
            ap = a[p] if p >= 0 else a_base
            Sqd = self.S[i] * qd[i]
            v[i] = X[i] @ vp + Sqd
            a[i] = X[i] @ ap + crm(v[i]) @ Sqd
            if qdd is not None:
                a[i] += self.S[i] * qdd[i]
        f = np.zeros((n, 6))
        for i in range(n):
            Iv = self.inertias[i] @ v[i]
            f[i] = self.inertias[i] @ a[i] + crf(v[i]) @ Iv
        return v, a, f

    def rnea_bpass(self, q, qd, f, qdd=None):
        """Backward pass → (c, f); adds the damping term
        (reference ``_test.py:78-107``) and — beyond the reference — the
        reflected rotor torque ``armatureᵢ·q̈ᵢ`` when ``qdd`` is given (the
        rotor inertia is joint-space only; ``f`` is untouched)."""
        n = self.n
        f = f.copy()
        c = np.zeros(n)
        X = self.xmats(q)
        for i in range(n - 1, -1, -1):
            c[i] = self.S[i] @ f[i]
            p = self.topo.parents[i]
            if p >= 0:
                f[p] += X[i].T @ f[i]
        c += self.damping * np.asarray(qd)
        if qdd is not None:
            c += self.armature * np.asarray(qdd)
        return c, f

    def rnea(self, q, qd, qdd=None, gravity=-9.81):
        v, a, f = self.rnea_fpass(q, qd, qdd, gravity)
        c, f = self.rnea_bpass(q, qd, f, qdd)
        return c, v, a, f

    # ----------------------------------------------------- analytic M⁻¹
    def minv_bpass(self, q):
        """Backward sweep of the analytic M⁻¹ recursion, separately
        callable (the reference exposes ``test_minv_bpass`` as its own
        stage, ``_test.py:117``): children before parents, articulated
        inertias propagated to the root. Returns the pass state
        ``(Minv, F, U, Dinv)`` that :meth:`minv_fpass` consumes —
        diff each tensor against a kernel's intermediates when the
        fused M⁻¹ diverges."""
        n = self.n
        X = self.xmats(q)
        IA = self.inertias.copy()
        Minv = np.zeros((n, n))
        F = np.zeros((n, 6, n))
        U = np.zeros((n, 6))
        Dinv = np.zeros(n)
        # backward sweep (children before parents; ids are topological)
        for i in range(n - 1, -1, -1):
            S = self.S[i]
            U[i] = IA[i] @ S
            # D = SᵀU + armature ⇒ the recursion inverts M + diag(armature)
            Dinv[i] = 1.0 / (S @ U[i] + self.armature[i])
            Minv[i, i] = Dinv[i]
            sub = list(self.topo.subtrees[i])
            Minv[i, sub] -= Dinv[i] * (S @ F[i][:, sub])
            p = self.topo.parents[i]
            if p >= 0:
                F[i][:, sub] += np.outer(U[i], Minv[i, sub])
                F[p] += X[i].T @ F[i]
                Ia = IA[i] - np.outer(U[i], Dinv[i] * U[i])
                IA[p] += X[i].T @ Ia @ X[i]
        return Minv, F, U, Dinv

    def minv_fpass(self, q, Minv, F, U, Dinv):
        """Forward sweep of the analytic M⁻¹ recursion (reference
        ``test_minv_fpass``, ``_test.py:186``): serial in i — the column
        slice ``i:`` forces it (``_direct_minv.py:304-310``). Consumes
        :meth:`minv_bpass`'s state (mutates ``Minv``/``F`` in place, as
        the reference does) and returns the SYMMETRIC_UPPER Minv."""
        n = self.n
        X = self.xmats(q)
        for i in range(n):
            p = self.topo.parents[i]
            if p >= 0:
                Minv[i, i:] -= Dinv[i] * ((U[i] @ X[i]) @ F[p][:, i:])
            F[i][:, i:] = np.outer(self.S[i], Minv[i, i:])
            if p >= 0:
                F[i][:, i:] += X[i] @ F[p][:, i:]
        return Minv

    def minv(self, q, dense: bool = True):
        """Analytic mass-matrix inverse (Carpentier's recursion; reference
        ``_test.py:117-226``). Returns upper-triangular unless ``dense``.
        Composition of the separately-callable :meth:`minv_bpass` and
        :meth:`minv_fpass` stages (reference ``test_minv``,
        ``_test.py:213-226``)."""
        Minv, F, U, Dinv = self.minv_bpass(q)
        Minv = self.minv_fpass(q, Minv, F, U, Dinv)
        if dense:
            n = self.n
            iu = np.triu_indices(n, 1)
            Minv[(iu[1], iu[0])] = Minv[iu]
        return Minv

    # ------------------------------------------------------ forward dynamics
    def fd(self, q, qd, u, gravity=-9.81):
        """qdd = M⁻¹ (u − c(q, q̇)) (reference ``_forward_dynamics.py``
        composition; golden path ``_test.py:496-501``)."""
        c, *_ = self.rnea(q, qd, None, gravity)
        return self.minv(q, True) @ (np.asarray(u) - c)

    # ------------------------------------------------------------- ∂RNEA/∂u
    def rnea_grad_inner(self, q, qd, qdd=None, gravity=-9.81):
        """Analytic ∂ID with EVERY stage's intermediate tensor returned —
        the reference's ``test_rnea_grad_inner`` contract
        (``_test.py:229-488``, all intermediate gradient tensors returned
        at ``:488``): when a fused ∂ID kernel diverges, diff the kernel's
        stage dumps against these instead of bisecting the final (n, 2n).

        Returns a dict:
          ``v, a, f``            — RNEA sweep states (n, 6)
          ``Iv, Xv, Xa``         — temp comps (n, 6)
            (fused loop, reference ``_inverse_dynamics_gradient.py:123-138``)
          ``SxXv, SxXa, Sxv, Sxf`` — the mx/fx column terms (n, 6)
            (reference ``:154-164``; Sxf uses the CORRECT force cross,
            see the crf-vs-crm note below)
          ``dv_dq, dv_dqd``      — forward wave outputs (n, 6, n)
            (reference ``:189-247``)
          ``da_dq, da_dqd``      — (n, 6, n) (reference ``:268-339``)
          ``df_dq_local, df_dqd_local`` — ∂f BEFORE the backward
            propagation (n, 6, n) (reference stages ``:360-430``)
          ``df_dq, df_dqd``      — after the backward waves (n, 6, n)
            (reference ``:477-541``)
          ``dc_dq, dc_dqd``      — the extracted (n, n) outputs
            (reference ``:592-635``; damping on the dc/dq̇ diagonal,
            ``_test.py:486``)
        """
        n = self.n
        _, v, a, f = self.rnea(q, qd, qdd, gravity)
        X = self.xmats(q)
        a_base = np.zeros(6)
        a_base[5] = -gravity
        parents = self.topo.parents

        # temporaries
        Iv = np.einsum("nij,nj->ni", self.inertias, v)
        Xv = np.zeros((n, 6))
        Xa = np.zeros((n, 6))
        for i in range(n):
            p = parents[i]
            Xv[i] = X[i] @ v[p] if p >= 0 else np.zeros(6)
            Xa[i] = X[i] @ (a[p] if p >= 0 else a_base)
        SxXv = np.stack([crm(self.S[i]) @ Xv[i] for i in range(n)])
        SxXa = np.stack([crm(self.S[i]) @ Xa[i] for i in range(n)])
        Sxv = np.stack([crm(self.S[i]) @ v[i] for i in range(n)])
        # Backward-pass correction uses the FORCE cross: ∂Xᵀ/∂q·f = Xᵀ·crf(S)·f
        # (since ∂X/∂q = −crm(S)·X). The reference uses mxS — the motion
        # cross — here (``_test.py:311,433-437``), which coincides with
        # crf(S)·f for revolute joints (all GRiD robots) but is WRONG for
        # prismatic ones; we implement the correct formula (validated against
        # jax.jacfwd in tests).
        Sxf = np.stack([crf(self.S[i]) @ f[i] for i in range(n)])
        # NOTE: reference computes mxS(S, w) = crm(w)·S = −crm(S)·w; see sign
        # handling below (we keep crm(S)·w and negate where needed).

        dv_dq = np.zeros((n, 6, n))   # [i] = ∂v_i/∂q (6 × n columns)
        dv_dqd = np.zeros((n, 6, n))
        da_dq = np.zeros((n, 6, n))
        da_dqd = np.zeros((n, 6, n))
        df_dq = np.zeros((n, 6, n))
        df_dqd = np.zeros((n, 6, n))

        # forward: ∂v
        for i in range(n):
            p = parents[i]
            if p >= 0:
                dv_dq[i] = X[i] @ dv_dq[p]
                dv_dqd[i] = X[i] @ dv_dqd[p]
                dv_dq[i][:, i] -= SxXv[i]     # reference: += mxS(S, Xv) = −crm(S)·Xv
            dv_dqd[i][:, i] += self.S[i]
        # ∂a, local part: mxS(S, dv/du)·qd + self column {mxS(S,Xa), mxS(S,v)}
        for i in range(n):
            cS = crm(self.S[i])
            da_dq[i] = -cS @ dv_dq[i] * qd[i]
            da_dqd[i] = -cS @ dv_dqd[i] * qd[i]
            da_dq[i][:, i] -= SxXa[i]
            da_dqd[i][:, i] -= Sxv[i]
        # ∂a, propagate down the tree
        for i in range(n):
            p = parents[i]
            if p >= 0:
                da_dq[i] += X[i] @ da_dq[p]
                da_dqd[i] += X[i] @ da_dqd[p]
        # ∂f, local: crf(dv)·Iv + I·da + crf(v)·I·dv
        for i in range(n):
            # crf(w)·x is linear in w (here x = Iv_i is fixed); the golden
            # path keeps a per-column loop for readability.
            for col in range(n):
                df_dq[i][:, col] = crf(dv_dq[i][:, col]) @ Iv[i]
                df_dqd[i][:, col] = crf(dv_dqd[i][:, col]) @ Iv[i]
            FxvI = crf(v[i]) @ self.inertias[i]
            df_dq[i] += self.inertias[i] @ da_dq[i] + FxvI @ dv_dq[i]
            df_dqd[i] += self.inertias[i] @ da_dqd[i] + FxvI @ dv_dqd[i]
        df_dq_local = df_dq.copy()
        df_dqd_local = df_dqd.copy()
        # backward: propagate ∂f to parents; q side gets −Xᵀ·(S×f) on own column
        for i in range(n - 1, -1, -1):
            p = parents[i]
            if p >= 0:
                df_dq[p] += X[i].T @ df_dq[i]
                df_dqd[p] += X[i].T @ df_dqd[i]
                # correct form of the reference's Xmxf correction (see the
                # crf-vs-crm note above): +Xᵀ·(crf(S)·f)
                df_dq[p][:, i] += X[i].T @ Sxf[i]
        # extract
        dc_dq = np.einsum("ij,ijk->ik", self.S, df_dq)
        dc_dqd = np.einsum("ij,ijk->ik", self.S, df_dqd) + np.diag(self.damping)
        return {
            "v": v, "a": a, "f": f, "Iv": Iv, "Xv": Xv, "Xa": Xa,
            "SxXv": SxXv, "SxXa": SxXa, "Sxv": Sxv, "Sxf": Sxf,
            "dv_dq": dv_dq, "dv_dqd": dv_dqd,
            "da_dq": da_dq, "da_dqd": da_dqd,
            "df_dq_local": df_dq_local, "df_dqd_local": df_dqd_local,
            "df_dq": df_dq, "df_dqd": df_dqd,
            "dc_dq": dc_dq, "dc_dqd": dc_dqd,
        }

    def rnea_grad(self, q, qd, qdd=None, gravity=-9.81):
        """Analytic (∂c/∂q, ∂c/∂q̇), each (n, n)
        (reference ``test_rnea_grad``, ``_test.py:490-494`` — the final
        outputs of :meth:`rnea_grad_inner`)."""
        out = self.rnea_grad_inner(q, qd, qdd, gravity)
        return out["dc_dq"], out["dc_dqd"]

    # --------------------------------------------------------------- ∂FD/∂u
    def fd_grad(self, q, qd, u, gravity=-9.81):
        """∂q̈/∂(q, q̇) = −M⁻¹ · ∂c/∂(q, q̇) at q̈ = FD(q, q̇, u)
        (Carpentier & Mansard; reference ``test_fd_grad``, ``_test.py:496-520``).
        Returns (n, 2n): columns [0:n) wrt q, [n:2n) wrt q̇."""
        c, *_ = self.rnea(q, qd, None, gravity)
        Minv = self.minv(q, True)
        qdd = Minv @ (np.asarray(u) - c)
        dc_dq, dc_dqd = self.rnea_grad(q, qd, qdd, gravity)
        return -Minv @ np.hstack([dc_dq, dc_dqd])

    # ----------------------------------------------- independent validators
    def crba(self, q) -> np.ndarray:
        """Composite-rigid-body mass matrix — an algorithm the reference does
        NOT contain, used as an independent cross-check of minv()."""
        n = self.n
        X = self.xmats(q)
        IC = self.inertias.copy()
        for i in range(n - 1, -1, -1):
            p = self.topo.parents[i]
            if p >= 0:
                IC[p] += X[i].T @ IC[i] @ X[i]
        M = np.zeros((n, n))
        for i in range(n):
            Fh = IC[i] @ self.S[i]
            M[i, i] = self.S[i] @ Fh + self.armature[i]
            j = i
            while self.topo.parents[j] >= 0:
                Fh = X[j].T @ Fh
                j = self.topo.parents[j]
                M[i, j] = M[j, i] = self.S[j] @ Fh
        return M

    def fk(self, q):
        """World pose (R, p) of every moving link frame."""
        Rs = np.zeros((self.n, 3, 3))
        ps = np.zeros((self.n, 3))
        for i in range(self.n):
            R_j, p_j = self._joint_pose(i, q[i])
            p = self.topo.parents[i]
            if p >= 0:
                Rs[i] = Rs[p] @ R_j
                ps[i] = Rs[p] @ p_j + ps[p]
            else:
                Rs[i] = R_j
                ps[i] = p_j
        return Rs, ps

    def energy(self, q, qd, gravity=-9.81):
        """Total mechanical energy (for conservation tests)."""
        v, _, _ = self.rnea_fpass(q, qd, None, 0.0)
        ke = 0.5 * sum(v[i] @ self.inertias[i] @ v[i] for i in range(self.n))
        # rotor kinetic energy ½·aᵢ·q̇ᵢ² (the armature's conserved share)
        ke += 0.5 * float(self.armature @ (np.asarray(qd) ** 2))
        Rs, ps = self.fk(q)
        pe = 0.0
        g = -gravity
        for i in range(self.n):
            m = self.inertias[i][5, 5]
            if m > 0:
                # unskew(m·ĉ): ĉ = [[0,-cz,cy],[cz,0,-cx],[-cy,cx,0]] stored at I[:3,3:]
                com = np.array([self.inertias[i][2, 4], self.inertias[i][0, 5],
                                self.inertias[i][1, 3]]) / m
                com_w = Rs[i] @ com + ps[i]
                pe += m * g * com_w[2]
        return ke + pe
