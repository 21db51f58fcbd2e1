"""The port's stance-constrained FD against the JAX package.

``stance_fd_plain``, the ``stance_fd_fused`` wrapper on CPU tensors and
``fb_constrained_fd_batched`` on free-flyer HyQ (four feet) and the 3-link
chain (one contact), float64; on the chain also with Baumgarte
stabilisation, explicit anchors and a Delassus ridge
(tests/test_contact_fused.py's arguments). The JAX reference is its
``fb_constrained_fd_batched`` with ``impl="vmap"`` — the second,
batch-last XLA pipeline of the same function — computed once a case (each
HyQ case costs about 10 s of eager JAX, so HyQ runs the plain case only),
and one interpret-mode ``stance_fd_fused`` on the chain. Also: the
contact-geometry errors, the plain solution's residuals in its two
equations on both robots and both cases (chip_smoke.py's check), that the
contact rows need the transforms of their links' support only, the device
copy of the foot geometry, the ``impl`` errors and that a CPU run never
reaches a kernel launch.

Tolerances are those the JAX package holds its two paths to: 1e-11 for v̇b
and λ, 1e-10 for q̈, relative to max(1, |ref|).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu.ops import contact as jct
from gridcodegenerator_tpu.ops import freeflyer as jff
from gridcodegenerator_tpu.ops.kernels import contact_fused as jcf
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import blops as tb
from gridcodegenerator_tpu_torch.ops import contact as tct
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops.kernels import _launch
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as tcf

torch.set_num_threads(1)

# robot → (URDF, links, offsets (k, 3), the joints' mean posture)
ROBOTS = {
    "hyq": (lambda z: z.hyq(damping=0.2), (2, 5, 8, 11),
            np.tile([0.35, 0.0, 0.0], (4, 1)), [-0.1, 0.7, -1.2]),
    "chain3": (lambda z: z.serial_chain(3, damping=0.1), (2,),
               np.asarray([[0.1, 0.0, 0.0]]), [0.0]),
}
CASES = ("plain", "baumgarte")
# the (robot, case) pairs held to the JAX package's batched pipeline
JAX_CASES = [("hyq", "plain"), ("chain3", "plain"), ("chain3", "baumgarte")]
TOLS = (1e-11, 1e-10, 1e-11)   # v̇b, q̈, λ
B = 6


def assert_close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


@functools.cache
def _case(name):
    """(JAX model, port model, batch-first numpy states (B, ·)): a unit
    quaternion, pos about z = 0.5, q about the posture ± 0.1, vb ± 0.6,
    q̇ ± 0.5, τ ± 10 (tests/test_contact_fused.py's ranges)."""
    urdf, _, _, posture = ROBOTS[name]
    jm = jff.free_flyer_model(g.parse_urdf(urdf(jzoo)), dtype=jnp.float64)
    tm = tff.free_flyer_model(gt.parse_urdf(urdf(tzoo)), device="cpu")
    n = jm.n
    rng = np.random.default_rng(5)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.5]
    q = (np.tile(posture, (B, n // len(posture)))
         + rng.uniform(-0.1, 0.1, (B, n)))
    vb = rng.uniform(-0.6, 0.6, (B, 6))
    qd = rng.uniform(-0.5, 0.5, (B, n))
    tau = rng.uniform(-10, 10, (B, n))
    return jm, tm, [quat, pos, q, vb, qd, tau]


def _kwargs(name, case):
    links = ROBOTS[name][1]
    if case == "plain":
        return {}
    anchors = np.random.default_rng(1).uniform(-0.1, 0.1, (len(links), 3))
    return dict(baumgarte=(3.0, 2.0), anchors=anchors, reg=1e-10)


@functools.cache
def _jax_ref(name, case):
    jm, _, s = _case(name)
    _, links, offsets, _ = ROBOTS[name]
    out = jct.fb_constrained_fd_batched(
        jm, *(jnp.asarray(x) for x in s), links, offsets, impl="vmap",
        **_kwargs(name, case))
    return tuple(np.asarray(o) for o in out)


def _cols(s):
    return [torch.from_numpy(x.T.copy()) for x in s]


# ------------------------------------------------------ against the JAX
@pytest.mark.parametrize("name,case", JAX_CASES)
def test_stance_plain_and_wrapper_match_jax(name, case):
    """stance_fd_plain and the wrapper on CPU tensors, batch last."""
    _, tm, s = _case(name)
    _, links, offsets, _ = ROBOTS[name]
    for fn in (tcf.stance_fd_plain, tcf.stance_fd_fused):
        out = fn(tm, *_cols(s), links, offsets, **_kwargs(name, case))
        for got, ref, tol in zip(out, _jax_ref(name, case), TOLS):
            assert_close(got, ref.T, tol)


@pytest.mark.parametrize("name,case", JAX_CASES)
def test_fb_constrained_fd_batched_matches_jax(name, case):
    """The public entry, batch first: HyQ's six states as a (2, 3) batch,
    the chain's as (6,) and a single state."""
    _, tm, s = _case(name)
    _, links, offsets, _ = ROBOTS[name]
    ref = _jax_ref(name, case)
    batches = [(2, 3)] if name == "hyq" else [(B,), ()]
    for batch in batches:
        k = int(np.prod(batch))
        states = [torch.from_numpy(x[:k].reshape(batch + x.shape[-1:]))
                  for x in s]
        out = tct.fb_constrained_fd_batched(tm, *states, links, offsets,
                                            **_kwargs(name, case))
        for got, r, tol in zip(out, ref, TOLS):
            assert tuple(got.shape) == batch + r.shape[-1:]
            assert_close(got, r[:k].reshape(batch + r.shape[-1:]), tol)


def test_stance_matches_interpret_kernel():
    """The wrapper on CPU tensors against the JAX Pallas kernel in
    interpret mode (chain, B = 3, Baumgarte, anchors and the ridge)."""
    jm, tm, s = _case("chain3")
    _, links, offsets, _ = ROBOTS["chain3"]
    kw = _kwargs("chain3", "baumgarte")
    cols = [x[:3].T.copy() for x in s]
    ref = jcf.stance_fd_fused(jm, *(jnp.asarray(c) for c in cols), links,
                              offsets, interpret=True, **kw)
    out = tcf.stance_fd_fused(tm, *(torch.from_numpy(c) for c in cols),
                              links, offsets, **kw)
    for got, r, tol in zip(out, ref, TOLS):
        assert_close(got, r, tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(ROBOTS))
def test_stance_residuals(name, case):
    """The plain solution meets both equations: J·y + J̇v = a* (up to the
    ridge's reg·|λ|) and M·y = [−f_b; τ − c_j] + Jᵀλ."""
    _, tm, s = _case(name)
    _, links, offsets, _ = ROBOTS[name]
    kw = _kwargs(name, case)
    cols = _cols(s)
    dvb, qdd, lam = tcf.stance_fd_plain(tm, *cols, links, offsets, **kw)
    con, dyn = chip_smoke.stance_residuals(
        tm, *cols, dvb, qdd, lam, links, offsets, kw.get("anchors"),
        baumgarte=kw.get("baumgarte", (0.0, 0.0)))
    assert float(con.max()) <= 1e-9 + kw.get("reg", 0.0) * float(
        lam.abs().max())
    assert float(dyn.max()) <= 1e-10


# ------------------------------------------------- support and geometry
@pytest.mark.parametrize("name", ["hyq", "atlas"])
def test_contact_rows_need_only_the_support(name):
    """The rows and points of the stance's contacts from the transforms of
    ancestors(link) ∪ {link} alone equal those from every transform: HyQ's
    four feet span all its joints, Atlas's two feet its legs only."""
    urdf, links = {"hyq": (tzoo.hyq(damping=0.2), ROBOTS["hyq"][1]),
                   "atlas": (tzoo.atlas(damping=0.1), (21, 27))}[name]
    tm = tff.free_flyer_model(gt.parse_urdf(urdf), device="cpu")
    support = tcf._support(tm.arm.topology, links)
    topo = tm.arm.topology
    assert support == sorted({j for l in links
                              for j in (*topo.ancestors[l], l)})
    assert (len(support) == tm.n) == (name == "hyq")
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.uniform(-0.5, 0.5, (tm.n, 2)))
    quat = torch.from_numpy(rng.normal(size=(4, 2)))
    R = tcf._quat_rot_s(quat / torch.linalg.vector_norm(quat, dim=0))
    offsets = np.tile([0.05, 0.0, -0.05], (len(links), 1))
    full = tcf._ff_contact_rows_s(
        tm, tb.joint_transforms_bl(tm.arm, q), R, links, offsets)
    part = tcf._ff_contact_rows_s(
        tm, tb.joint_transforms_bl(tm.arm, q, joints=support), R, links,
        offsets)
    for a, b in zip(full[1], part[1]):
        assert torch.equal(a, b)
    for ra, rb in zip(full[0], part[0]):
        for a, b in zip(ra, rb):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)


def test_device_geometry_is_copied_once():
    """The wrapper's foot offsets and anchors: values are copied to the
    model's device once and the copy is reused; a wrong count raises."""
    _, tm, _ = _case("hyq")
    offsets = np.tile([0.35, 0.0, 0.0], (4, 1))
    a = tcf._device_geom(tm, offsets, 4)
    assert tuple(a.shape) == (4, 3) and a.dtype == tm.dtype
    assert tcf._device_geom(tm, offsets.tolist(), 4) is a
    assert torch.equal(a, torch.from_numpy(offsets))
    assert tcf._device_geom(tm, torch.from_numpy(offsets), 4) is a
    assert tcf._device_geom(tm, None, 4) is None
    with pytest.raises(ValueError, match=r"expected \(4, 3\)"):
        tcf._device_geom(tm, offsets[:3], 4)


# ------------------------------------------------------------- errors
@pytest.mark.parametrize("case", ["empty", "range", "negative", "offsets"])
def test_check_contacts_matches_jax(case):
    """The contact-geometry errors, with the JAX package's messages."""
    n = 12
    links, offsets = {
        "empty": ((), np.zeros((0, 3))),
        "range": ((2, 12), np.zeros((2, 3))),
        "negative": ((-1,), np.zeros((1, 3))),
        "offsets": ((2, 5), np.zeros((2, 2))),
    }[case]
    with pytest.raises(ValueError) as ref:
        jct._check_contacts(n, links, offsets)
    with pytest.raises(ValueError) as got:
        tct._check_contacts(n, links, offsets)
    assert str(got.value) == str(ref.value)


def test_fb_constrained_fd_rejects_bad_geometry():
    _, tm, s = _case("chain3")
    states = [torch.from_numpy(x) for x in s]
    with pytest.raises(ValueError, match="out of range"):
        tct.fb_constrained_fd_batched(tm, *states, (3,), np.zeros((1, 3)))
    with pytest.raises(ValueError, match=r"offsets must be \(1, 3\)"):
        tct.fb_constrained_fd_batched(tm, *states, (2,), np.zeros(3))
    with pytest.raises(ValueError, match="pos must have trailing dimension 3"):
        tct.fb_constrained_fd_batched(tm, states[0], states[3], *states[2:],
                                      (2,), np.zeros((1, 3)))


def test_stance_impl_errors_and_no_launch(monkeypatch):
    """``impl="cuda"`` on CPU tensors and ``"vmap"`` raise; on CPU tensors
    the entry runs the plain version and never reaches a launch."""
    _, tm, s = _case("chain3")
    _, links, offsets, _ = ROBOTS["chain3"]
    states = [torch.from_numpy(x) for x in s]
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tct.fb_constrained_fd_batched(tm, *states, links, offsets,
                                      impl="cuda")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, 'The per-state tier"):
        tct.fb_constrained_fd_batched(tm, *states, links, offsets,
                                      impl="vmap")
    before = dict(_launch.LAUNCHES)

    def no_launch(*a, **kw):
        raise AssertionError("a CPU tensor reached a kernel launch")
    monkeypatch.setattr(tcf, "launch", no_launch)
    tct.fb_constrained_fd_batched(tm, *states, links, offsets)
    assert _launch.LAUNCHES == before


def test_stance_no_fallback_off_cpu():
    """Tensors on neither the CPU nor a CUDA device raise."""
    _, tm, _ = _case("chain3")
    _, links, offsets, _ = ROBOTS["chain3"]
    meta = [torch.empty((d, 3), dtype=torch.float64, device="meta")
            for d in (4, 3, tm.n, 6, tm.n, tm.n)]
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tcf.stance_fd_fused(tm, *meta, links, offsets)
    assert _launch.LAUNCHES == before
