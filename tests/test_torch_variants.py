"""The port's fixed-base M⁻¹ and FD variants — the JAX package's A/B
kernels that no public entry point takes by default — on CPU tensors (their
plain versions) in float64:

* the column-blocked M⁻¹ bodies (``blops.minv_UD_bl``, ``minv_cols_bl``)
  on the branched arm and the prismatic chain at a block that leaves a
  ragged last block, ``fd_grad_bl``'s ``minv_fn`` with the dense M⁻¹ and
  ``fd_bl``, against the JAX bodies (eager, no Pallas);
* one call of each new Pallas function — ``fused.forward_dynamics_fused``,
  ``fused.fd_grad_fused(minv_impl="dense")``, ``staged.fd_dense_staged``,
  ``staged.minv_staged`` and ``staged.minv_qdd_af_dense_staged`` — against
  JAX in interpret mode (``block_b=4``, 5 states) on the smallest robot that
  shows its structure;
* the staged ∇FD's and ∂ID's options (``minv_impl="recursion"``,
  ``merge_af``, ``fuse_finish=False``, ``merge_sides=False``), and
  ``fd_staged``, held to the port's default pipeline, which
  ``test_torch_staged.py`` holds to JAX;
* bf16 staging against full-precision staging and against one JAX
  interpret-mode ``stage_dtype=jnp.bfloat16`` call; ``to_stage`` against
  JAX's ``astype(jnp.bfloat16)``, bit for bit;
* Atlas (n = 28) against the float64 golden model;
* errors and routing.

Tolerances: 1e-10·max(1, |ref|) per element against JAX (the same sums in
the same order); 1e-9·max(1, |ref|) per state against the golden model;
1e-9 for the recursion M⁻¹ against the dense one (two algorithms: JAX's own
``test_crba_and_dense_minv_staged`` bound), 1e-12 for options that change
only the launches; bf16 staging 2e-2 relative to max(1, |ref|) against
full precision (JAX's ``test_staged_bf16_staging``) and more than 1e-6 from
it, 1e-10·max(1, |ref|) per element against JAX's bf16 staging (the same
roundings of the same stage values).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup, random_state
from gridcodegenerator_tpu.ops import blops as jb
from gridcodegenerator_tpu.ops.kernels import fused as jf
from gridcodegenerator_tpu.ops.kernels import staged as js
from gridcodegenerator_tpu_torch.ops import blops as tb
from gridcodegenerator_tpu_torch.ops.kernels import _build, _launch
from gridcodegenerator_tpu_torch.ops.kernels import fused as tf
from gridcodegenerator_tpu_torch.ops.kernels import staged as ts

torch.set_num_threads(1)

B = 5
CB = 2   # barm (n = 9): blocks 2, 2, 2, 2, 1; chain5p (n = 5): 2, 2, 1


def assert_close(got, ref, tol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


def assert_rel(got, ref, tol):
    """max|got − ref| ≤ tol · max(1, max|ref|) over the whole tensor."""
    got, ref = got.double(), ref.double()
    rel = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    assert rel <= tol, f"rel err {rel:.3e}"


def assert_staged(got, full, floor=1e-6):
    """bf16 staging moved the result: max|got − full| > floor ·
    max(1, max|full|)."""
    rel = float((got - full).abs().max()) / max(1.0, float(full.abs().max()))
    assert rel > floor, f"bf16 staging changed nothing (rel {rel:.3e})"


@functools.cache
def _case(name):
    desc, _, jm = get_setup(name)
    q, qd, u = (x.T.copy() for x in random_state(desc.n, seed=23, batch=(B,)))
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    return jm, tm, q, qd, u


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# ----------------------------------------------------- against the JAX bodies
@pytest.mark.parametrize("name", ["barm", "chain5p"])
def test_minv_blocks_match_jax(name):
    """K2's U, D⁻¹ and K3's column blocks, ragged last block included;
    siblings under a moving parent (barm), prismatic joints (chain5p)."""
    jm, tm, q, _, _ = _case(name)
    Xj = jb.joint_transforms_bl(jm, jnp.asarray(q))
    Xt = tb.joint_transforms_bl(tm, torch.from_numpy(q))
    Uj, Dj = jb.minv_UD_bl(jm, Xj)
    Ut, Dt = tb.minv_UD_bl(tm, Xt)
    for a, b in zip(Ut + Dt, Uj + Dj):
        assert_close(a.expand(b.shape), b)
    for c0 in range(0, tm.n, CB):
        w = min(CB, tm.n - c0)
        assert_close(tb.minv_cols_bl(tm, Xt, Ut, Dt, c0, w),
                     jb.minv_cols_bl(jm, Xj, Uj, Dj, c0, w))


def test_dense_minv_fd_grad_and_fd_bl_match_jax():
    """``fd_grad_bl(minv_fn=_dense_minv_bl)`` and ``fd_bl`` on the double
    pendulum (eager JAX takes ≈ 13 s on the chain, ≈ 20 s on barm; the
    dense M⁻¹ at n = 5 and 9 and ``fd_bl`` at 9 are held below)."""
    jm, tm, q, qd, u = _case("dpend")
    ref = jb.fd_grad_bl(jm, *_j(q, qd, u), minv_fn=jf._dense_minv_bl)
    got = tb.fd_grad_bl(tm, *_t(q, qd, u), minv_fn=tf._dense_minv_bl)
    for a, b in zip(got, ref):
        assert_close(a, b)
    assert_close(tb.fd_bl(tm, *_t(q, qd, u)), jb.fd_bl(jm, *_j(q, qd, u)))


# ------------------------------------------------------ JAX in interpret mode
def test_forward_dynamics_fused_matches_jax():
    jm, tm, q, qd, u = _case("barm")
    ref = jf.forward_dynamics_fused(jm, *_j(q, qd, u), block_b=4,
                                    interpret=True)
    assert_close(tf.forward_dynamics_fused(tm, *_t(q, qd, u)), ref)


def test_fd_grad_fused_dense_matches_jax():
    """On the double pendulum: the interpret-mode ∇FD body costs ≈ 20 s
    at n = 5; the dense M⁻¹ is held at n = 5 (K2″ below) and n = 9
    (``test_torch_staged.py``'s K2′)."""
    jm, tm, q, qd, u = _case("dpend")
    ref = jf.fd_grad_fused(jm, *_j(q, qd, u), block_b=4, interpret=True,
                           minv_impl="dense")
    for a, b in zip(tf.fd_grad_fused(tm, *_t(q, qd, u), minv_impl="dense"),
                    ref):
        assert_close(a, b)


def test_fd_dense_staged_matches_jax():
    jm, tm, q, qd, u = _case("barm")
    ref = js.fd_dense_staged(jm, *_j(q, qd, u), block_b=4, interpret=True)
    assert_close(ts.fd_dense_staged(tm, *_t(q, qd, u)), ref)


def test_minv_staged_matches_jax():
    jm, tm, q, _, _ = _case("chain5p")
    ref = js.minv_staged(jm, jnp.asarray(q), block_b=4, cb=CB,
                         interpret=True)
    assert_close(ts.minv_staged(tm, torch.from_numpy(q), cb=CB), ref)


def test_minv_qdd_af_dense_staged_matches_jax():
    """K2″ given K1's u − c and v (JAX's own K1 outputs on both sides)."""
    jm, tm, q, qd, u = _case("chain5p")
    c, v = ts.bias_and_v_staged(tm, *_t(q, qd))
    umc = torch.from_numpy(u) - c
    ref = js.minv_qdd_af_dense_staged(jm, *_j(q, qd, umc.numpy(), v.numpy()),
                                      block_b=4, interpret=True)
    got = ts.minv_qdd_af_dense_staged(tm, *_t(q, qd), umc, v)
    for a, b in zip(got, ref):
        assert_close(a, b)


# ---------------------------------- the options, held to the default pipeline
@functools.cache
def _default(name="barm"):
    _, tm, q, qd, u = _case(name)
    return (ts.fd_grad_staged(tm, *_t(q, qd, u), cb=CB),
            ts.id_grad_staged(tm, *_t(q, qd, u), cb=CB))


def test_fd_staged_and_minv_staged_match_dense():
    """The recursion M⁻¹ (K2, K3 at a ragged block, densify) and
    ``fd_staged`` against K2′ and its q̈ (1e-9)."""
    _, tm, q, qd, u = _case("barm")
    tq, tqd, tu = _t(q, qd, u)
    c, _ = ts.bias_and_v_staged(tm, tq, tqd)
    Minv, qdd = ts.minv_qdd_dense_staged(tm, tq, tu - c)
    assert_close(ts.minv_staged(tm, tq, cb=CB), Minv, 1e-9)
    assert_close(ts.fd_staged(tm, tq, tqd, tu, cb=CB), qdd, 1e-9)
    assert_close(ts.fd_dense_staged(tm, tq, tqd, tu), qdd, 1e-9)


@pytest.mark.parametrize("opts, tol", [
    (dict(minv_impl="recursion"), 1e-9),
    (dict(merge_af=True), 1e-12),
    (dict(fuse_finish=False), 1e-12),
    (dict(merge_sides=False), 1e-12),
], ids=["recursion", "merge_af", "unfused_finish", "per_side"])
def test_fd_grad_staged_options(opts, tol):
    _, tm, q, qd, u = _case("barm")
    got = ts.fd_grad_staged(tm, *_t(q, qd, u), cb=CB, **opts)
    for a, b in zip(got, _default()[0]):
        assert_close(a, b, tol)


def test_id_grad_staged_per_side():
    _, tm, q, qd, u = _case("barm")
    got = ts.id_grad_staged(tm, *_t(q, qd, u), cb=CB, merge_sides=False)
    for a, b in zip(got, _default()[1]):
        assert_close(a, b, 1e-12)


# ------------------------------------------------------------ bf16 staging
def test_bf16_staging_tracks_full_precision():
    """v, M⁻¹, a, f staged in bf16 (∇FD, with every option that changes
    the stages) and v, a, f (∂ID): outputs stay float64, within bf16
    round-off of the full-precision pipeline, and farther from it than
    1e-6 relative (a dropped cast fails)."""
    _, tm, q, qd, u = _case("barm")
    s = _t(q, qd, u)
    fd_ref, id_ref = _default()
    for opts in ({}, dict(merge_af=True), dict(minv_impl="recursion"),
                 dict(fuse_finish=False, merge_sides=False)):
        got = ts.fd_grad_staged(tm, *s, cb=CB, stage_dtype=torch.bfloat16,
                                **opts)
        for a, b in zip(got, fd_ref):
            assert a.dtype == torch.float64
            assert_rel(a, b, 2e-2)
            assert_staged(a, b)
    got = ts.id_grad_staged(tm, *s, cb=CB, stage_dtype=torch.bfloat16,
                            merge_sides=False)
    for a, b in zip(got, id_ref):
        assert a.dtype == torch.float64
        assert_rel(a, b, 2e-2)
        assert_staged(a, b)


def test_bf16_staging_matches_jax():
    """One JAX interpret-mode ``stage_dtype=jnp.bfloat16`` ∇FD, on the
    double pendulum (barm's blocks cost ≈ 45 s in interpret mode, the
    chain's ≈ 19 s; the bf16 casts do not depend on the robot)."""
    jm, tm, q, qd, u = _case("dpend")
    ref = js.fd_grad_staged(jm, *_j(q, qd, u), block_b=4, cb=2,
                            interpret=True, stage_dtype=jnp.bfloat16)
    got = ts.fd_grad_staged(tm, *_t(q, qd, u), cb=2,
                            stage_dtype=torch.bfloat16)
    full = ts.fd_grad_staged(tm, *_t(q, qd, u), cb=2)
    for a, b, c in zip(got, ref, full):
        assert_close(a, np.array(b))
        assert_staged(a, c)


def test_to_stage_rounds_once():
    """``to_stage`` equals JAX's ``astype(jnp.bfloat16)`` bit for bit: each
    step of float64 → float32 → bf16 rounds once, to nearest even, so
    1 + 2⁻⁸ + 2⁻⁴⁰ (just past a bf16 halfway point) lands on the halfway
    point in float32 and then rounds to even (1.0); on those halfway values
    and on 1000 seeded float64 and float32 values."""
    h = 1.0 + 2.0 ** -8
    halves = np.array([h + 2.0 ** -40, h - 2.0 ** -40, h, -h - 2.0 ** -40])
    rng = np.random.default_rng(0)
    wide = rng.standard_normal(1000) * 10.0 ** rng.integers(-6, 6, 1000)
    for x in (halves, wide, wide.astype(np.float32)):
        got = ts.to_stage(torch.from_numpy(x))
        ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        assert np.array_equal(got.view(torch.int16).numpy(),
                              ref.view(np.int16))
    assert ts.to_stage(torch.from_numpy(halves)).double().tolist() == [
        1.0, 1.0, 1.0, -1.0]


# --------------------------------------------------------------- Atlas slice
@functools.cache
def _atlas():
    desc, gold, _ = get_setup("atlas")
    q, qd, u = random_state(desc.n, seed=31, batch=(2,))
    tm = gt.load_robot(ROBOTS["atlas"], dtype=torch.float64, device="cpu")
    return gold, tm, q, qd, u


def _per_state_close(got, ref_fn, q, qd, u, tol=1e-9):
    for s in range(q.shape[0]):
        ref = ref_fn(q[s], qd[s], u[s])
        out = got[..., s].numpy()
        err = np.abs(out - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), f"{err:.3e}"


def test_atlas_variants_match_golden():
    """Atlas (n = 28, three trees): ``forward_dynamics_fused`` (routed to
    the factor-solve), ``fd_staged``, ``minv_staged`` and the recursion
    ∇FD against the golden model."""
    gold, tm, q, qd, u = _atlas()
    tq, tqd, tu = (torch.from_numpy(x.T.copy()) for x in (q, qd, u))
    _per_state_close(tf.forward_dynamics_fused(tm, tq, tqd, tu),
                     gold.fd, q, qd, u)
    _per_state_close(ts.fd_staged(tm, tq, tqd, tu), gold.fd, q, qd, u)
    _per_state_close(ts.minv_staged(tm, tq),
                     lambda q_, *_: gold.minv(q_, True), q, qd, u)
    J = torch.cat(ts.fd_grad_staged(tm, tq, tqd, tu, minv_impl="recursion"),
                  dim=1)
    _per_state_close(J, gold.fd_grad, q, qd, u)


# ------------------------------------------------------- errors and routing
def test_errors():
    _, tm, q, qd, u = _case("barm")
    s = _t(q, qd, u)
    with pytest.raises(ValueError, match="cb must be in"):
        ts.minv_staged(tm, s[0], cb=_build.minv_col_block(tm.n) + 1)
    with pytest.raises(ValueError, match="cb must be in"):
        ts.fd_grad_staged(tm, *s, cb=_build.default_col_block(tm.n) + 1)
    with pytest.raises(ValueError,
                       match="fuse_finish: no VMEM-valid column block"):
        ts.fd_grad_staged(tm, *s, fuse_finish=True,
                          cb=_build.default_col_block(tm.n) + 1)
    with pytest.raises(ValueError, match="minv_impl"):
        ts.fd_grad_staged(tm, *s, minv_impl="lane")
    with pytest.raises(ValueError, match="minv_impl"):
        tf.fd_grad_fused(tm, *s, minv_impl="lane")
    with pytest.raises(ValueError, match="stage_dtype"):
        ts.fd_grad_staged(tm, *s, stage_dtype=torch.float16)
    with pytest.raises(ValueError, match="sides"):
        ts.grad_cols_plain(tm, s[0], s[1], *ts.vaf_plain(tm, *s),
                           sides=("qd", "q"))


def _track(monkeypatch, module, names, called=None):
    called = [] if called is None else called
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name, **k: (
            called.append(_n), _r(*a, **k))[1])
    return called


def test_merge_af_gate(monkeypatch):
    """``merge_af=True`` runs K2″ in place of K2′ and K4 at every n (K2″
    builds at every n on the card); the default runs K2′ and K4."""
    _, tm, q, qd, u = _case("barm")
    called = _track(monkeypatch, ts, ("minv_af_plain", "minv_qdd_dense_plain",
                                      "af_plain"))
    ts.fd_grad_staged(tm, *_t(q, qd, u), merge_af=True)
    assert called == ["minv_af_plain"]
    called.clear()
    ts.fd_grad_staged(tm, *_t(q, qd, u))
    assert called == ["minv_qdd_dense_plain", "af_plain"]


def test_routes_by_joint_count(monkeypatch):
    """``forward_dynamics_fused``: the composition up to MAX_KERNEL_JOINTS,
    the factor-solve past it; ``fd_grad_fused(minv_impl="dense")`` past it
    takes the staged ∇FD with its default K2′."""
    _, tm, q, qd, u = _case("barm")
    assert _build.dense_grads(tm.n)
    called = _track(monkeypatch, ts, ("fd_dense_plain",
                                      "minv_qdd_dense_plain"))
    _track(monkeypatch, tf, ("forward_dynamics_plain", "fd_grad_plain"),
           called)
    tf.forward_dynamics_fused(tm, *_t(q, qd, u))
    tf.fd_grad_fused(tm, *_t(q, qd, u), minv_impl="dense")
    assert called == ["forward_dynamics_plain", "fd_grad_plain"]
    called.clear()
    monkeypatch.setattr(_build, "MAX_KERNEL_JOINTS", tm.n - 1)
    tf.forward_dynamics_fused(tm, *_t(q, qd, u))
    tf.fd_grad_fused(tm, *_t(q, qd, u), minv_impl="dense")
    assert called == ["fd_dense_plain", "minv_qdd_dense_plain"]


NEW_WRAPPERS = {
    "forward_dynamics_fused": lambda tm, st, v, M: tf.forward_dynamics_fused(
        tm, st, st, st),
    "fd_grad_fused_dense": lambda tm, st, v, M: tf.fd_grad_fused(
        tm, st, st, st, minv_impl="dense"),
    "fd_dense_staged": lambda tm, st, v, M: ts.fd_dense_staged(tm, st, st,
                                                               st),
    "minv_staged": lambda tm, st, v, M: ts.minv_staged(tm, st),
    "fd_staged": lambda tm, st, v, M: ts.fd_staged(tm, st, st, st),
    "minv_af": lambda tm, st, v, M: ts.minv_qdd_af_dense_staged(
        tm, st, st, st, v),
    "grad_cols_side": lambda tm, st, v, M: ts.grad_cols_staged(
        tm, st, st, v, v, v, Minv=M, sides=("qd",)),
    "fd_grad_staged_bf16": lambda tm, st, v, M: ts.fd_grad_staged(
        tm, st, st, st, stage_dtype=torch.bfloat16, minv_impl="recursion"),
}


@pytest.mark.parametrize("wrapper", list(NEW_WRAPPERS))
def test_no_fallback_off_cpu(wrapper):
    """Tensors neither on the CPU nor on a CUDA device raise; no plain
    version runs and nothing is counted."""
    tm = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64, device="cpu")
    n = tm.n
    st = torch.empty((n, 3), dtype=torch.float64, device="meta")
    v = torch.empty((6, n, 3), dtype=torch.float64, device="meta")
    M = torch.empty((n, n, 3), dtype=torch.float64, device="meta")
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        NEW_WRAPPERS[wrapper](tm, st, v, M)
    assert _launch.LAUNCHES == before


def test_cpu_runs_plain_without_launch():
    _, tm, q, qd, u = _case("dpend")
    before = dict(_launch.LAUNCHES)
    s = _t(q, qd, u)
    tf.forward_dynamics_fused(tm, *s)
    tf.fd_grad_fused(tm, *s, minv_impl="dense")
    ts.fd_grad_staged(tm, *s, minv_impl="recursion", merge_sides=False,
                      stage_dtype=torch.bfloat16)
    ts.fd_grad_staged(tm, *s, merge_af=True, fuse_finish=False)
    assert _launch.LAUNCHES == before
