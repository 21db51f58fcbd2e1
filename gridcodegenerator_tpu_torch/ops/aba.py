"""Forward dynamics by Featherstone's articulated-body algorithm (ABA).

The port's counterpart of ``gridcodegenerator_tpu/ops/aba.py``; so far only
its batch-last form :func:`aba_bl` (aba.py:158-223), the plain version of
the ABA kernel (``kernels/csrc/aba.cuh``). q̈ in O(n) a state: no (6, n)
force matrix and no M⁻¹, only a 6×6 articulated inertia and a 6-vector bias
force per joint. Gravity enters as the fictitious base acceleration
[0,…,0,−g]; viscous damping is folded into the bias torque and armature
into D = SᵀU + armature.

Three passes:
  1. forward:  v_i = X_i v_p + S_i q̇_i;  ζ_i = v_i × S_i q̇_i;
     pA_i = v_i ×* I_i v_i.
  2. backward: U = Iᴬ S, D = Sᵀ U + armature, ū = τ − d·q̇ − Sᵀ pᴬ;
     Iᵃ = Iᴬ − U D⁻¹ Uᵀ, pᵃ = pᴬ + Iᵃ ζ + U D⁻¹ ū;
     Iᴬ_p += X_iᵀ Iᵃ X_i, pᴬ_p += X_iᵀ pᵃ.
  3. forward:  a′ = X_i a_p + ζ_i;  q̈_i = D⁻¹ (ū_i − Uᵀ a′);
     a_i = a′ + S_i q̈_i.
"""

from __future__ import annotations

import torch

from ..models.robot import RobotModel
from .blops import (_col, _mat, crf_apply_bl, crm_apply_bl,
                    joint_transforms_bl, matvec6, matvec6_T)


def aba_bl(model: RobotModel, q, qd, u, gravity=-9.81, X=None):
    """Batch-last ABA: q/q̇/u (n, B) → q̈ (n, B)."""
    n = model.n
    parents = model.topology.parents
    if X is None:
        X = joint_transforms_bl(model, q)
    Sb = [_col(model.S[i]) for i in range(n)]

    v = [None] * n
    zeta = [None] * n
    for i in range(n):
        p = parents[i]
        Sqd = Sb[i] * qd[i:i + 1]
        v[i] = Sqd if p < 0 else matvec6(X[i], v[p]) + Sqd
        zeta[i] = crm_apply_bl(v[i], Sqd)
    IA = [_mat(model.inertia[i]) for i in range(n)]
    pA = [crf_apply_bl(v[i], matvec6(IA[i], v[i])) for i in range(n)]

    U = [None] * n
    Dinv = [None] * n
    ubar = [None] * n
    for i in range(n - 1, -1, -1):
        S = Sb[i]
        Ui = sum(IA[i][:, c] * S[c:c + 1] for c in range(6))      # (6,B)
        d = sum(S[c:c + 1] * Ui[c:c + 1] for c in range(6))       # (1,B)
        Di = 1.0 / (d + model.armature[i:i + 1, None])
        SpA = sum(S[c:c + 1] * pA[i][c:c + 1] for c in range(6))  # (1,B)
        ui = (u[i:i + 1] - model.damping[i:i + 1, None] * qd[i:i + 1]) - SpA
        U[i], Dinv[i], ubar[i] = Ui, Di, ui
        p = parents[i]
        if p >= 0:
            # Iᵃ = Iᴬ − D⁻¹·U Uᵀ, the rank-1 outer product as (6,1,B)·(1,6,B)
            UDi = Ui * Di
            Ia = IA[i] - UDi[:, None] * Ui[None]
            pa = pA[i] + matvec6(Ia, zeta[i]) + UDi * ui
            # Xᵀ Iᵃ X: two 6×6 batch-last products
            IaX = sum(Ia[:, c][:, None] * X[i][c][None] for c in range(6))
            IA[p] = IA[p] + sum(
                X[i][c][:, None] * IaX[c][None] for c in range(6))
            pA[p] = pA[p] + matvec6_T(X[i], pa)

    a = [None] * n
    qdd = [None] * n
    for i in range(n):
        p = parents[i]
        if p < 0:
            a_prime = X[i][:, 5] * (-gravity) + zeta[i]
        else:
            a_prime = matvec6(X[i], a[p]) + zeta[i]
        Ua = sum(U[i][c:c + 1] * a_prime[c:c + 1] for c in range(6))
        qdd[i] = Dinv[i] * (ubar[i] - Ua)
        a[i] = a_prime + Sb[i] * qdd[i]
    return torch.cat(qdd, dim=0)
