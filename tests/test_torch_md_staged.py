"""The port's staged multi-dof pipeline and CRBA forward dynamics against
the JAX package.

The staged stages (K1md ``md_vaf_staged``, K2md ``md_minv_fused`` and
``md_minv_qdd_fused``, the column-blocked K5md) and both pipelines
(``md_id_grad_staged``, ``md_fd_grad_staged``) on CPU tensors — their plain
versions — against the JAX ``multidof_staged`` functions, and
``md_fd_fused`` against the JAX one, on the JAX package's three multi-dof
test robots (the ball arm, free-joint iiwa-14, a mixed revolute/prismatic
chain), float64. The JAX references run their kernel bodies eagerly with
``force_xla=True`` — no interpret-mode Pallas — and the port's models come
from the JAX models' arrays through ``md_from_jax_arrays``. Column widths 2,
3 and 4 cut a multi-dof joint: the ball arm's first ball joint at 2, free
iiwa-14's six root directions at 3 and 4, under the port's blocks (from
0, ragged last) and the JAX package's equal-ish ones alike.

Also: the staged path against the port's single-kernel plain path; free
Atlas (n 29, nq 35, nv 34, past ``MAX_MD_GRAD_NV``) through the batched
entries against central differences of the port's ABA; the routing, the
column-width checks, the build key and no fallback off the CPU.

Tolerances: 1e-10·max(1, |ref|) per element against JAX (the same sums in
the same order); 1e-9 between the staged and the single-kernel paths (the
staged q̈ is an explicit M⁻¹ product, not the Cholesky solve — the JAX
package's own bound for the same comparison,
tests/test_multidof_fused.py:150-178).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu.ops import multidof as jmd
from gridcodegenerator_tpu.ops.kernels import multidof_fused as jmf
from gridcodegenerator_tpu.ops.kernels import multidof_staged as jms
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import multidof as tmd
from gridcodegenerator_tpu_torch.ops.kernels import _build, _launch
from gridcodegenerator_tpu_torch.ops.kernels import multidof_fused as tmf
from gridcodegenerator_tpu_torch.ops.kernels import multidof_staged as tms

torch.set_num_threads(1)

ROBOTS = {
    "ball": lambda z: z.ball_arm(damping=0.1),
    "free": lambda z: z.with_free_joint(z.iiwa14(damping=0.1)),
    "mixed": lambda z: z.serial_chain(5, damping=0.1, prismatic_every=2),
}
WIDTHS = (2, 3, 4)
B = 4


def assert_close(got, ref, tol=1e-10):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


@functools.cache
def _case(name):
    """(JAX model, port model through md_from_jax_arrays, batch-last
    numpy states q (nq, B), q̇, u (nv, B)): neutral_q ⊕ a tangent in
    [−0.6, 0.6], q̇ ∈ [−0.8, 0.8], u ∈ [−5, 5]."""
    jm = jmd.multidof_model_from_description(
        g.parse_urdf(ROBOTS[name](jzoo)), dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jm, f)) for f in tmd.MD_FIELDS}
    tm = gt.md_from_jax_arrays(arrays, jm.topology.parents, jm.joint_types,
                               jm.q_slices, jm.v_slices, jm.name,
                               device="cpu")
    rng = np.random.default_rng(31)
    q0 = jmd.neutral_q(jm)
    q = np.stack([np.asarray(jmd.md_tangent_apply(jm, q0, jnp.asarray(d)))
                  for d in rng.uniform(-0.6, 0.6, (B, jm.nv))]).T.copy()
    qd = rng.uniform(-0.8, 0.8, (jm.nv, B))
    u = rng.uniform(-5, 5, (jm.nv, B))
    return jm, tm, (q, qd, u)


def _t(states):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in states]


def _j(states):
    return [jnp.asarray(x) for x in states]


# pipeline → (JAX function, port plain pipeline, number of (q, q̇, u)
# inputs; u stands for q̈ in ∂ID)
PIPELINES = {
    "fd_grad": (jms.md_fd_grad_staged, tms.md_fd_grad_staged_plain, 3),
    "id_grad": (jms.md_id_grad_staged, tms.md_id_grad_staged_plain, 3),
    "id_grad_noqdd": (jms.md_id_grad_staged, tms.md_id_grad_staged_plain,
                      2),
}


@functools.cache
def _jax_pipeline(name, pipe, cb):
    jm, _, s = _case(name)
    fn, _, k = PIPELINES[pipe]
    return tuple(np.asarray(o) for o in fn(jm, *_j(s[:k]), cb=cb,
                                           force_xla=True))


# ------------------------------------------------------------ pipelines
@pytest.mark.parametrize("cb", WIDTHS)
@pytest.mark.parametrize("pipe", list(PIPELINES))
@pytest.mark.parametrize("name", list(ROBOTS))
def test_staged_pipelines_match_jax(name, pipe, cb):
    """Both staged pipelines, plain, and through their wrappers on CPU
    tensors, at column widths that cut a multi-dof joint."""
    _, tm, s = _case(name)
    _, plain, k = PIPELINES[pipe]
    wrapper = (tms.md_fd_grad_staged if pipe == "fd_grad"
               else tms.md_id_grad_staged)
    refs = _jax_pipeline(name, pipe, cb)
    for fn in (plain, wrapper):
        got = fn(tm, *_t(s[:k]), cb=cb)
        assert len(got) == len(refs)
        for g_, r_ in zip(got, refs):
            assert_close(g_, r_)


def test_blocks_cut_multidof_joints():
    """The widths above do cut: a block boundary falls inside a ball or
    free joint's directions."""
    for name, cb in (("ball", 2), ("free", 3), ("free", 4)):
        _, tm, _ = _case(name)
        cuts = [c0 for c0, _ in tms._blocks(tm.nv, cb)
                if any(sv < c0 < sv + w for sv, w in tm.v_slices)]
        assert cuts, (name, cb)
        jax_cuts = [c0 for c0, _ in jms._split_cols(tm.nv, cb)
                    if any(sv < c0 < sv + w for sv, w in tm.v_slices)]
        assert jax_cuts, (name, cb)


# --------------------------------------------------------------- stages
STAGES = {
    "vaf": (lambda jm, s: jms.md_vaf_staged(jm, *s, force_xla=True),
            tms.md_vaf_staged, 3),
    "vaf_noqdd": (lambda jm, s: jms.md_vaf_staged(jm, *s, None,
                                                  force_xla=True),
                  lambda tm, q, qd: tms.md_vaf_staged(tm, q, qd, None), 2),
    "minv": (lambda jm, s: (jms.md_minv_fused(jm, *s, force_xla=True),),
             tms.md_minv_fused, 1),
    "minv_qdd": (lambda jm, s: jms.md_minv_qdd_fused(jm, *s,
                                                     force_xla=True),
                 tms.md_minv_qdd_fused, 3),
    "md_fd": (lambda jm, s: (jmf.md_fd_fused(jm, *s, force_xla=True),),
              tmf.md_fd_fused, 3),
}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("name", list(ROBOTS))
def test_stages_match_jax(name, stage):
    """K1md (with and without q̈), K2md (with and without the bias force
    and q̈) and the CRBA forward dynamics, each on CPU tensors."""
    jm, tm, s = _case(name)
    jfn, tfn, k = STAGES[stage]
    refs = [np.asarray(r) for r in jfn(jm, _j(s[:k]))]
    got = tfn(tm, *_t(s[:k]))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(refs)
    for g_, r_ in zip(got, refs):
        assert_close(g_, r_)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_crba_fd_matches_aba_and_entry(name):
    """md_fd_fused's q̈ against the port's ABA (another recursion: 1e-9),
    and ``impl="crba"`` of the batched entry against the wrapper."""
    _, tm, s = _case(name)
    q, qd, u = _t(s)
    qdd = tmf.md_fd_fused(tm, q, qd, u)
    assert_close(qdd, tmf.md_aba_fused(tm, q, qd, u).numpy(), tol=1e-9)
    api = gt.md_forward_dynamics_batched(tm, q.T, qd.T, u.T, impl="crba")
    assert torch.equal(api, qdd.T)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_staged_vs_single_kernel_plain(name):
    """The staged pipelines at the built width against the single-kernel
    plain path: ∂ID identical in value, ∇FD at 1e-9."""
    _, tm, s = _case(name)
    q, qd, u = _t(s)
    for got, ref in zip(tms.md_fd_grad_staged(tm, q, qd, u),
                        tmf.md_fd_grad_plain(tm, q, qd, u)):
        assert_close(got, ref.numpy(), tol=1e-9)
    for qdd in (u, None):
        for got, ref in zip(tms.md_id_grad_staged(tm, q, qd, qdd),
                            tmf.md_id_grad_plain(tm, q, qd, qdd)):
            assert_close(got, ref.numpy(), tol=1e-12)


# ---------------------------------------------------------- free Atlas
@functools.cache
def _atlas():
    m = gt.multidof_model_from_description(
        gt.parse_urdf(tzoo.with_free_joint(tzoo.atlas(damping=0.1))),
        dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(11)

    def uni(r):
        return torch.rand((2, m.nv), generator=gen, dtype=torch.float64) \
            * (2 * r) - r
    q = gt.md_tangent_apply(m, gt.neutral_q(m).expand(2, -1), uni(0.6))
    return m, (q, uni(0.8), uni(5.0))


def test_free_atlas_fd_grad_vs_central_differences():
    """Free Atlas past MAX_MD_GRAD_NV through the batched ∇FD entry (the
    staged route): ∂q̈/∂δq and ∂q̈/∂q̇ against central differences of the
    port's ABA along md_tangent_apply at 1e-6, ∂q̈/∂u·(u − c) against
    ABA's q̈ at 1e-9."""
    m, (q, qd, u) = _atlas()
    nv, h = m.nv, 1e-6
    assert (m.n, m.nq, nv) == (29, 35, 34) and nv > _build.MAX_MD_GRAD_NV
    J = gt.md_forward_dynamics_gradient_batched(m, q, qd, u)
    assert all(tuple(o.shape) == (2, nv, nv) and bool(o.isfinite().all())
               for o in J)
    dirs = (torch.eye(nv, dtype=torch.float64) * h)[:, None].expand(nv, 2,
                                                                     nv)
    rep = lambda x: x[None].expand(nv, 2, x.shape[-1])
    for side, D in ((0, J[0]), (1, J[1])):
        outs = []
        for sign in (1.0, -1.0):
            x = [rep(q), rep(qd), rep(u)]
            x[side] = (gt.md_tangent_apply(m, x[0], sign * dirs) if side == 0
                       else x[1] + sign * dirs)
            outs.append(gt.md_forward_dynamics_batched(m, *x))
        fd = ((outs[0] - outs[1]) / (2 * h)).permute(1, 2, 0)
        err = ((D - fd).abs().amax((1, 2))
               / fd.abs().amax((1, 2)).clamp(min=1.0))
        assert float(err.max()) <= 1e-6, (side, float(err.max()))
    c = gt.md_inverse_dynamics_batched(m, q, qd)
    got = torch.einsum("bij,bj->bi", J[2], u - c)
    ref = gt.md_forward_dynamics_batched(m, q, qd, u)
    err = (got - ref).abs().amax(1) / ref.abs().amax(1).clamp(min=1.0)
    assert float(err.max()) <= 1e-9, float(err.max())


def test_free_atlas_id_grad_routes_and_is_exact():
    """Free Atlas's batched ∂ID entry returns the staged result, which
    equals the single-kernel plain ∂ID (the blocks change no value)."""
    m, (q, qd, u) = _atlas()
    got = gt.md_id_grad_batched(m, q, qd, u)
    ref = tmf.md_id_grad_plain(m, q.T.contiguous(), qd.T.contiguous(),
                               u.T.contiguous())
    for g_, r_ in zip(got, ref):
        assert tuple(g_.shape) == (2, m.nv, m.nv)
        assert_close(g_.movedim(0, -1).contiguous(), r_.numpy(), tol=1e-12)


# -------------------------------------------------------------- routing
@pytest.mark.parametrize("limit_offset", [0, 1, -1])
def test_routing_follows_max_md_grad_nv(monkeypatch, limit_offset):
    """At and below MAX_MD_GRAD_NV the gradient entries take the
    single-thread wrappers, above it the staged pipelines; the staged unit
    is built by default only above it."""
    _, tm, s = _case("free")
    monkeypatch.setattr(_build, "MAX_MD_GRAD_NV", tm.nv + limit_offset)
    calls = []
    for mod, fn in ((tmf, "md_fd_grad_fused"), (tmf, "md_id_grad_fused"),
                    (tms, "md_fd_grad_staged"), (tms, "md_id_grad_staged")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    q, qd, u = (x.T.copy() for x in s)
    gt.md_forward_dynamics_gradient_batched(tm, *_t((q, qd, u)))
    gt.md_id_grad_batched(tm, *_t((q, qd, u)))
    staged = limit_offset < 0
    assert calls == (["md_fd_grad_staged", "md_id_grad_staged"] if staged
                     else ["md_fd_grad_fused", "md_id_grad_fused"])
    units = _build._units(_build.topology_key(tm))
    assert units == (("md.cu", "md_staged.cu") if staged else ("md.cu",))


@pytest.mark.parametrize("cb", [0, -1, 14])
def test_col_block_out_of_range_raises(cb):
    _, tm, s = _case("free")
    assert _build.md_col_block(tm.n, tm.nv) == 13
    q, qd, u = _t(s)
    with pytest.raises(ValueError, match=r"cb must be in \[1, 13\]"):
        tms.md_fd_grad_staged(tm, q, qd, u, cb=cb)
    with pytest.raises(ValueError, match=r"cb must be in \[1, 13\]"):
        tms.md_id_grad_staged(tm, q, qd, u, cb=cb)


def test_build_key_carries_column_width():
    """The md macros carry K5md's compiled width: 4 at free Atlas, the
    whole nv on a small robot; the staged unit's sources are hashed."""
    m, _ = _atlas()
    key = _build.topology_key(m)
    assert _build.md_col_block(m.n, m.nv) == 4
    assert "-DGRID_MD_CB=4" in _build._macros(key)
    assert _build._units(key) == ("md.cu", "md_staged.cu")
    _, tm, _ = _case("ball")
    assert f"-DGRID_MD_CB={tm.nv}" in _build._macros(
        _build.topology_key(tm))
    assert "md_staged.cuh" in _build._HEADERS
    assert _build.unit_of("grid_md_grad_cols") == "md_staged.cu"
    assert _build.unit_of("grid_md_fd") == "md.cu"


def _meta(*shapes):
    return [torch.empty(sh + (3,), dtype=torch.float64, device="meta")
            for sh in shapes]


@pytest.mark.parametrize("stage", ["vaf", "minv", "minv_qdd", "grad_cols",
                                   "id_grad", "fd_grad", "md_fd"])
def test_staged_no_fallback_off_cpu(stage):
    """Tensors on neither the CPU nor a CUDA device raise: no stage runs
    its plain version off the CPU, and nothing is counted."""
    _, tm, _ = _case("ball")
    n, nq, nv = tm.n, tm.nq, tm.nv
    q, v = _meta((nq,), (nv,))
    (x6,) = _meta((6, n))
    call = {"vaf": lambda: tms.md_vaf_staged(tm, q, v, v),
            "minv": lambda: tms.md_minv_fused(tm, q),
            "minv_qdd": lambda: tms.md_minv_qdd_fused(tm, q, v, v),
            "grad_cols": lambda: tms.md_grad_cols_staged(tm, q, v, x6, x6,
                                                         x6),
            "id_grad": lambda: tms.md_id_grad_staged(tm, q, v, v),
            "fd_grad": lambda: tms.md_fd_grad_staged(tm, q, v, v),
            "md_fd": lambda: tmf.md_fd_fused(tm, q, v, v)}[stage]
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert _launch.LAUNCHES == before
