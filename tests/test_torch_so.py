"""Second order in the port (``ops/so.py``, ``ops/kernels/so_fused.py``,
``ops/kernels/so_staged.py`` and the three API entries) on CPU tensors, in
float64, against the JAX package:

* the plain [∂q̈/∂q | ∂q̈/∂q̇ | M⁻¹], H and λᵀ·H on the branched arm, and
  the API's on iiwa-14, against the JAX package's ``so.fd_grad_full`` and
  ``so.forward_dynamics_hessian`` (one jitted vmap of both a robot: the
  batch-last JAX Hessian takes minutes to compile on one core, the
  per-state one seconds; the two agree in the JAX package's own tests);
* the staged λᵀ·H pipeline (T1, T2, T4, T5 on their plain stages, and the
  assembly) forced on iiwa-14 and on the branched arm at a ragged column
  block, against the same reference, and its exact zero blocks;
* Atlas (n = 28) through the public API on the staged route, against
  central differences of λᵀ·``forward_dynamics_gradient_full`` from the
  port's own staged routes along all 84 coordinate directions (compiling
  the JAX package at n = 28 is too slow for this suite);
* the routing and the API's contract.

Tolerance 1e-10·max(1, |ref|) per element against JAX; 1e-6·max(1, |H|)
against the central differences (h = 1e-5: truncation ~h²·|∂³q̈|, round-off
~1e-16·|J|/h).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup
from gridcodegenerator_tpu.ops import so as jso
from gridcodegenerator_tpu_torch.ops import so as tso
from gridcodegenerator_tpu_torch.ops.kernels import _build, _launch, so_fused
from gridcodegenerator_tpu_torch.ops.kernels import so_staged as tss

torch.set_num_threads(1)

B = 4
# the T5 column block forced on the branched arm (n = 9): blocks 4, 4, 1
BARM_CB = 4


def assert_close(got, ref, tol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


def _states(n, batch, seed):
    """q, q̇, u, λ (batch, n) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-r, r, tuple(batch) + (n,))
                 for r in (2.0, 1.5, 8.0, 1.0))


@functools.cache
def _case(name):
    """(model, q, q̇, u, λ batch-first, JAX J (B, n, 3n), JAX H
    (B, n, 3n, 3n))."""
    _, _, jm = get_setup(name)
    q, qd, u, lam = _states(jm.n, (B,), seed=23)

    @jax.jit
    def ref(q, qd, u):
        return jax.vmap(lambda a, b, c: (jso.fd_grad_full(jm, a, b, c),
                                         jso.forward_dynamics_hessian(
                                             jm, a, b, c)))(q, qd, u)

    J, H = (np.asarray(x) for x in ref(*(jnp.asarray(s) for s in (q, qd, u))))
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    return tm, q, qd, u, lam, J, H


def _cols(*xs):
    """batch-first numpy → (n, B) torch."""
    return [torch.from_numpy(np.ascontiguousarray(x.T)) for x in xs]


def _vp_ref(H, lam):
    return np.einsum("bi,bijk->bjk", lam, H)


# --------------------------------------------- the plain versions vs JAX
def test_fd_grad_full_matches_jax():
    tm, q, qd, u, _, J, _ = _case("barm")
    got = tso.fd_grad_full_bl(tm, *_cols(q, qd, u))
    assert_close(got.movedim(-1, 0), J)


@pytest.mark.parametrize("with_lam", [False, True])
def test_hessian_plain_matches_jax(with_lam):
    tm, q, qd, u, lam, _, H = _case("barm")
    if with_lam:
        got = tso.forward_dynamics_hessian_bl(tm, *_cols(q, qd, u),
                                              lam=_cols(lam)[0])
        ref = _vp_ref(H, lam)
    else:
        got = tso.forward_dynamics_hessian_bl(tm, *_cols(q, qd, u))
        ref = H
    assert_close(got.movedim(-1, 0), ref)


# ------------------------------------------- the staged pipeline vs JAX
@pytest.mark.parametrize("name,cb", [("iiwa14", None), ("barm", BARM_CB)])
def test_staged_vp_matches_jax(name, cb):
    """K1, K2′, K4, K5 and the tangent stages T1, T2, T4, T5 on their plain
    versions, forced on a small robot; the (q̇, u) and (u, u) blocks are
    exact zeros."""
    tm, q, qd, u, lam, _, H = _case(name)
    got = tss.fd_hessian_vp_staged(tm, *_cols(q, qd, u, lam), cb=cb)
    assert_close(got.movedim(-1, 0), _vp_ref(H, lam))
    n = tm.n
    assert torch.all(got[n:2 * n, 2 * n:] == 0)
    assert torch.all(got[2 * n:, n:] == 0)


# ----------------------------------------------------- the public API
@pytest.mark.parametrize("entry", ["forward_dynamics_gradient_full",
                                   "forward_dynamics_hessian",
                                   "forward_dynamics_hessian_vp"])
def test_api_matches_jax(entry):
    tm, q, qd, u, lam, J, H = _case("iiwa14")
    args = [torch.from_numpy(x) for x in (q, qd, u)]
    ref = {"forward_dynamics_gradient_full": J,
           "forward_dynamics_hessian": H,
           "forward_dynamics_hessian_vp": _vp_ref(H, lam)}[entry]
    if entry == "forward_dynamics_hessian_vp":
        args.append(torch.from_numpy(lam))
    assert_close(getattr(gt, entry)(tm, *args), ref)


def test_api_batch_shapes():
    """Leading batch dims and a single state keep the JAX API's shapes."""
    m = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64, device="cpu")
    n = m.n
    for batch in ((2, 3), ()):
        q, qd, u, lam = (torch.from_numpy(x) for x in _states(n, batch, 3))
        assert gt.forward_dynamics_gradient_full(m, q, qd, u).shape \
            == batch + (n, 3 * n)
        assert gt.forward_dynamics_hessian(m, q, qd, u).shape \
            == batch + (n, 3 * n, 3 * n)
        assert gt.forward_dynamics_hessian_vp(m, q, qd, u, lam).shape \
            == batch + (3 * n, 3 * n)


# ---------------------------------------------------------- Atlas slice
def test_atlas_vp_matches_central_differences():
    """λᵀ·H on Atlas through the API (the staged route on its plain
    stages) against central differences of λᵀ·[∂q̈/∂q | ∂q̈/∂q̇ | M⁻¹]
    from the port's staged ∇FD and K2′, all 2·84·2 perturbed states in one
    batch."""
    m = gt.load_robot(ROBOTS["atlas"], dtype=torch.float64, device="cpu")
    n, n3, S, h = m.n, 3 * m.n, 2, 1e-5
    assert not _build.dense_hessian_vp(n)
    q, qd, u, lam = _states(n, (S,), seed=31)
    H = gt.forward_dynamics_hessian_vp(
        m, *(torch.from_numpy(x) for x in (q, qd, u, lam))).numpy()
    x = np.concatenate([q, qd, u], axis=1)                       # (S, 3n)
    steps = np.eye(n3) * h
    xs = np.concatenate([x[:, None] + steps, x[:, None] - steps], axis=1)
    xs = xs.reshape(-1, n3)                                      # (S·2·3n,)
    J = gt.forward_dynamics_gradient_full(
        m, *(torch.from_numpy(np.ascontiguousarray(xs[:, k * n:(k + 1) * n]))
             for k in range(3))).numpy().reshape(S, 2, n3, n, n3)
    g = np.einsum("si,sdkij->sdkj", lam, J)                      # (S,2,3n,3n)
    fd = (g[:, 0] - g[:, 1]).transpose(0, 2, 1) / (2 * h)        # [s, j, k]
    scale = max(1.0, np.abs(H).max())
    assert np.abs(H - fd).max() <= 1e-6 * scale, \
        f"max err {np.abs(H - fd).max():.3e} (scale {scale:.3e})"


# -------------------------------------------------- routing and contract
@pytest.mark.parametrize("limit", ["MAX_HESSIAN_JOINTS",
                                   "MAX_HESSIAN_VP_JOINTS"])
def test_forced_staged_route_matches_single(monkeypatch, limit):
    """Past MAX_HESSIAN_VP_JOINTS (forced here) λᵀ·H runs the staged
    pipeline and the full tensor stays on the single-thread route; past
    MAX_HESSIAN_JOINTS both run the staged pipeline, the full tensor as n
    λᵀ·H calls. Either route agrees with the single-thread plain version."""
    m = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64, device="cpu")
    q, qd, u, lam = (torch.from_numpy(x) for x in _states(m.n, (3,), 5))
    assert _build.dense_hessian_vp(m.n)
    single_vp = gt.forward_dynamics_hessian_vp(m, q, qd, u, lam)
    single = gt.forward_dynamics_hessian(m, q, qd, u)
    monkeypatch.setattr(_build, limit, 0)
    called = []
    real = tss.fd_hessian_vp_staged
    monkeypatch.setattr(tss, "fd_hessian_vp_staged", lambda *a, **k: (
        called.append(1), real(*a, **k))[1])
    monkeypatch.setattr(so_fused, "fd_hessian_vp_plain",
                        lambda *a, **k: pytest.fail("single λᵀ·H reached"))
    assert_close(gt.forward_dynamics_hessian_vp(m, q, qd, u, lam),
                 single_vp.numpy())
    assert len(called) == 1
    assert_close(gt.forward_dynamics_hessian(m, q, qd, u), single.numpy())
    assert len(called) == (1 + m.n if limit == "MAX_HESSIAN_JOINTS" else 1)


def _meta_call(wrapper, tm):
    """Call ``wrapper`` on tensors that are neither on the CPU nor on a
    CUDA device: it must raise, not run the plain version."""
    n = tm.n
    st = torch.empty((n, 3), dtype=torch.float64, device="meta")
    per_dir = torch.empty((n, n, 3), dtype=torch.float64, device="meta")
    vaf = torch.empty((6, n, 3), dtype=torch.float64, device="meta")
    dvaf = torch.empty((n, 6, n, 3), dtype=torch.float64, device="meta")
    calls = {
        "hessian_vp": lambda: so_fused.fd_hessian_vp_fused(tm, st, st, st, st),
        "hessian": lambda: so_fused.fd_hessian_fused(tm, st, st, st),
        "t1": lambda: tss.t1_staged(tm, st, st, 0),
        "t2": lambda: tss.t2_staged(tm, st, st, st, per_dir, per_dir),
        "t4": lambda: tss.t4_staged(tm, st, st, st, vaf, dvaf, per_dir, 1),
        "t5": lambda: tss.t5_staged(tm, st, st, vaf, vaf, vaf, st, dvaf,
                                    dvaf, dvaf, 0, "q"),
        "vp_staged": lambda: tss.fd_hessian_vp_staged(tm, st, st, st, st),
    }
    calls[wrapper]()


@pytest.mark.parametrize("name", ["dpend", "atlas"])
@pytest.mark.parametrize("wrapper", ["hessian_vp", "hessian", "t1", "t2",
                                     "t4", "t5", "vp_staged"])
def test_no_fallback_off_cpu(wrapper, name):
    """Every second-order wrapper, on either route, raises for a tensor
    that is not on the CPU and launches nothing."""
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _meta_call(wrapper, tm)
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize("entry", ["forward_dynamics_gradient_full",
                                   "forward_dynamics_hessian",
                                   "forward_dynamics_hessian_vp"])
def test_impl_cuda_on_cpu_raises(entry):
    m = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64, device="cpu")
    x = torch.zeros((3, m.n), dtype=torch.float64)
    args = (x,) * (4 if entry.endswith("_vp") else 3)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        getattr(gt, entry)(m, *args, impl="cuda")


@pytest.mark.parametrize("shape", [(3, 3), (2, 2), (2,)])
def test_lam_shape_errors(shape):
    """λ is checked like the states: its trailing dimension, then its batch
    shape, each with a named error."""
    m = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64, device="cpu")
    x = torch.zeros((3, m.n), dtype=torch.float64)
    lam = torch.zeros(shape, dtype=torch.float64)
    match = ("lam must have trailing dimension n=2" if shape[-1] != 2
             else "state batch shapes disagree")
    with pytest.raises(ValueError, match=match):
        gt.forward_dynamics_hessian_vp(m, x, x, x, lam)


def test_stage_arguments_checked():
    m = gt.load_robot(ROBOTS["barm"], dtype=torch.float64, device="cpu")
    q = torch.zeros((m.n, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="which must be"):
        tss.t1_staged(m, q, q, 2)
    with pytest.raises(ValueError, match="side must be"):
        tss.t5_staged(m, q, q, *(None,) * 7, 0, "u")
    with pytest.raises(ValueError, match="cb must be in"):
        tss.fd_hessian_vp_staged(m, q, q, q, q,
                                 cb=_build.so_col_block(m.n) + 1)
