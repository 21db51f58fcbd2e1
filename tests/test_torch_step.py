"""The port's frictional ground stepper against the JAX package.

``step_ground_plain``, the ``step_ground_fused`` and
``step_ground_terrain_fused`` wrappers on CPU tensors, and the public
``fb_step_ground_batched`` / ``fb_simulate_ground_batched``, float64,
against the JAX ``fb_step_ground_batched`` / ``fb_simulate_ground_batched``
with ``impl="xla"`` — its batch-last XLA body, which the JAX package's own
tests hold to its interpret-mode step kernels at 1e-11
(tests/test_contact_fused.py) — computed once a case (an eager HyQ step
costs about 9 s, so HyQ runs the plain and the options cases, the chain
the heightfield and the rollout). Also: the port's ``ops/terrain.py``
against the JAX one, the step helpers, every ``mu`` layout and the
B == k error, the options that are not ported, and that a CPU run never
reaches a kernel launch.

Tolerance: 1e-11 absolute, as the JAX package holds its two step paths.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu.ops import contact as jct
from gridcodegenerator_tpu.ops import freeflyer as jff
from gridcodegenerator_tpu.ops import terrain as jtr
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import contact as tct
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops import terrain as ttr
from gridcodegenerator_tpu_torch.ops.kernels import _launch
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as tcf

torch.set_num_threads(1)

TOL = 1e-11
DT = 1e-3
# robot → (URDF, feet, offsets (k, 3))
ROBOTS = {
    "hyq": (lambda z: z.hyq(damping=0.2), (2, 5, 8, 11),
            np.tile([0.35, 0.0, 0.0], (4, 1))),
    "chain3": (lambda z: z.serial_chain(3, damping=0.1), (2,),
               np.asarray([[0.1, 0.0, 0.0]])),
}
OUTS = ("quat", "pos", "q", "vb", "qd")


def _states(name, B, seed):
    """tests/test_contact_fused.py's states: HyQ at its stance posture
    (``_states``), the chain as in its rollout test (pos about z = 0.2)."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    if name == "hyq":
        n = 12
        pos = rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.5]
        q = np.tile([-0.1, 0.7, -1.2], (B, 4)) + rng.uniform(-0.1, 0.1,
                                                             (B, n))
        vb = rng.uniform(-0.6, 0.6, (B, 6))
        qd = rng.uniform(-0.5, 0.5, (B, n))
        tau = rng.uniform(-10, 10, (B, n))
        return [quat, pos, q, vb, qd, tau]
    n = 3
    pos = rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.2]
    return [quat, pos, rng.uniform(-0.3, 0.3, (B, n)),
            rng.uniform(-0.3, 0.3, (B, 6)), rng.uniform(-0.3, 0.3, (B, n)),
            rng.uniform(-2, 2, (B, n))]


@functools.cache
def _models(name):
    urdf = ROBOTS[name][0]
    jm = jff.free_flyer_model(g.parse_urdf(urdf(jzoo)), dtype=jnp.float64)
    tm = tff.free_flyer_model(gt.parse_urdf(urdf(tzoo)), device="cpu")
    return jm, tm


def _mus(B, k):
    return np.random.default_rng(2).uniform(0.3, 1.0, (B, k))


@functools.cache
def _jax_terrain():
    return jtr.bumpy_terrain(amp=0.05, wavelength=0.9, extent=2.0, cell=0.25,
                             rough=0.02, dtype=jnp.float64)


def _port_terrain(jt):
    """A JAX Terrain on the port's side: the same grid, origin and cell."""
    return ttr.make_terrain(np.asarray(jt.heights), np.asarray(jt.origin),
                            jt.cell, dtype=torch.float64, device="cpu")


def _options(k, B, n):
    """The combined options case: a push, a soft contact (erp and softness
    from soft_contact_params), restitution, effort and projected limits."""
    erp, soft = jct.soft_contact_params(5e4, 2e3, DT)
    rng = np.random.default_rng(3)
    return dict(erp=float(erp), softness=float(soft), restitution=0.3,
                effort=np.full(n, 6.0),
                limits=(np.full(n, -0.5), np.full(n, 0.6)),
                f_base=rng.uniform(-20, 20, (B, 6)))


# (robot, B, seed, case) → the JAX step's outputs
CASES = {"flat": ("hyq", 4, 7), "options": ("hyq", 4, 7),
         "terrain": ("chain3", 6, 11)}


@functools.cache
def _jax_step(case):
    name, B, seed = CASES[case]
    jm, _ = _models(name)
    _, links, offsets = ROBOTS[name]
    s = _states(name, B, seed)
    kw = {"terrain": _jax_terrain()} if case == "terrain" else {}
    if case == "options":
        kw = _options(len(links), B, jm.n)
    nxt, imp = jct.fb_step_ground_batched(
        jm, tuple(jnp.asarray(x) for x in s[:5]), jnp.asarray(s[5]), DT,
        links, offsets, mu=jnp.asarray(_mus(B, len(links))), impl="xla",
        **kw)
    return tuple(np.asarray(x) for x in nxt), np.asarray(imp)


def _port_kwargs(case, B, k, n):
    if case == "terrain":
        return {"terrain": _port_terrain(_jax_terrain())}
    if case == "options":
        kw = _options(k, B, n)
        kw["f_base"] = torch.from_numpy(kw["f_base"])
        return kw
    return {}


def assert_close(got, ref, tol=TOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref)
    assert float(err.max()) <= tol, f"{what}: max err {err.max():.3e}"


def _check_active(imp):
    """Some normal impulse > 0 and some tangential one ≠ 0: the check is
    not vacuous."""
    assert (imp[..., 2] > 0).any(), "no active contact in these states"
    assert (np.abs(imp[..., :2]) > 1e-9).any(), "no friction impulse"


# ------------------------------------------------------------- terrain
@pytest.mark.parametrize("kind", ["flat", "slope", "bumpy"])
def test_terrain_constructors_match_jax(kind):
    """The constructors give the JAX package's grid, origin and cell."""
    kw = {"flat": dict(height=0.1, extent=2.0, cell=0.5),
          "slope": dict(grade_x=0.2, grade_y=-0.1, extent=2.0, cell=0.5),
          "bumpy": dict(amp=0.05, wavelength=0.9, extent=2.0, cell=0.25,
                        rough=0.02)}[kind]
    jt = getattr(jtr, f"{kind}_terrain")(dtype=jnp.float64, **kw)
    tt = getattr(ttr, f"{kind}_terrain")(dtype=torch.float64,
                                            device="cpu", **kw)
    assert_close(tt.heights, jt.heights, 0.0)
    assert_close(tt.origin, jt.origin, 0.0)
    assert tt.cell == jt.cell


def test_terrain_surface_matches_jax():
    """Heights, gradients, normals and contact frames at points inside
    the grid, on cell edges and outside it (linear extrapolation)."""
    jt = _jax_terrain()
    tt = _port_terrain(jt)
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-1.9, 1.9, 40), [-2.0, 0.25, 2.0, -3.1,
                                                      2.7, 0.5]])
    y = np.concatenate([rng.uniform(-1.9, 1.9, 40), [-2.0, -0.5, 3.3, 0.1,
                                                      -2.9, 2.0]])
    ref = jtr.terrain_height_grad(jt, jnp.asarray(x), jnp.asarray(y))
    got = ttr.terrain_height_grad(tt, torch.from_numpy(x),
                                  torch.from_numpy(y))
    for a, b, what in zip(got, ref, ("h", "hx", "hy")):
        assert_close(a, b, 1e-15, what)
    hj, nj = jtr.terrain_surface(jt, jnp.asarray(x), jnp.asarray(y))
    ht, nt = ttr.terrain_surface(tt, torch.from_numpy(x), torch.from_numpy(y))
    assert_close(nt, nj, 1e-15, "normal")
    assert_close(ttr.contact_frame(nt), jtr.contact_frame(nj), 1e-15,
                 "frame")
    with pytest.raises(ValueError, match="heights must be"):
        ttr.make_terrain(np.zeros((1, 4)), device="cpu")
    with pytest.raises(ValueError, match="heights must be"):
        ttr.placed(ttr.Terrain(torch.zeros(4, 1), torch.zeros(2), 0.1),
                   "cpu", torch.float64)


def test_terrain_copy_is_kept():
    """The stepper's device copy of a terrain is made once a device and
    dtype and renewed after an in-place edit."""
    tt = _port_terrain(_jax_terrain())
    a, x0, y0 = ttr.placed(tt, "cpu", torch.float32)
    assert a.heights.dtype == torch.float32 and (x0, y0) == (-2.0, -2.0)
    assert ttr.placed(tt, "cpu", torch.float32)[0] is a
    assert ttr.placed(tt, "cpu", torch.float64)[0].heights is tt.heights
    tt.heights[0, 0] += 1.0
    b = ttr.placed(tt, "cpu", torch.float32)[0]
    assert b is not a and torch.equal(b.heights, tt.heights.float())


# ---------------------------------------------------------- the step
@pytest.mark.parametrize("route", ["plain", "wrapper", "entry"])
def test_step_matches_jax(route):
    """HyQ's four feet, per-environment μ (B, 4): the plain body and the
    wrapper batch last, and the public entry batch first."""
    nxt, imp = _jax_step("flat")
    _check_active(imp)
    _, tm = _models("hyq")
    _, links, offsets = ROBOTS["hyq"]
    B = 4
    s = _states("hyq", B, 7)
    mus = _mus(B, 4)
    if route == "entry":
        got, gimp = tct.fb_step_ground_batched(
            tm, tuple(torch.from_numpy(x) for x in s[:5]),
            torch.from_numpy(s[5]), DT, links, offsets,
            mu=torch.from_numpy(mus))
        for a, b, what in zip(got, nxt, OUTS):
            assert_close(a, b, what=what)
        assert_close(gimp, imp, what="impulses")
        return
    fn = tcf.step_ground_plain if route == "plain" else tcf.step_ground_fused
    out = fn(tm, *(torch.from_numpy(x.T.copy()) for x in s),
             torch.from_numpy(mus.T.copy()), DT, links, offsets)
    for a, b, what in zip(out[:5], nxt, OUTS):
        assert_close(a.T, b, what=what)
    assert_close(out[5].T.reshape(B, 4, 3), imp, what="impulses")


def test_step_options_match_jax():
    """One case with every ported option at once: a base push
    (``f_base``), a soft contact (``soft_contact_params``), restitution,
    ``effort`` and projected ``limits``."""
    nxt, imp = _jax_step("options")
    _check_active(imp)
    _, tm = _models("hyq")
    _, links, offsets = ROBOTS["hyq"]
    B = 4
    s = _states("hyq", B, 7)
    got, gimp = tct.fb_step_ground_batched(
        tm, tuple(torch.from_numpy(x) for x in s[:5]),
        torch.from_numpy(s[5]), DT, links, offsets,
        mu=torch.from_numpy(_mus(B, 4)), **_port_kwargs("options", B, 4, 12))
    for a, b, what in zip(got, nxt, OUTS):
        assert_close(a, b, what=what)
    assert_close(gimp, imp, what="impulses")
    # the limits bind and the push moves the base: not a vacuous case
    assert float(got[2].max()) == 0.6


@pytest.mark.parametrize("route", ["plain", "wrapper", "entry"])
def test_step_terrain_matches_jax(route):
    """The heightfield (a rough egg carton, 0.25 m cells) on the 3-link
    chain: gaps along the surface normal and the foot's rows in its contact
    frame."""
    nxt, imp = _jax_step("terrain")
    _check_active(imp)
    _, tm = _models("chain3")
    _, links, offsets = ROBOTS["chain3"]
    B = 6
    s = _states("chain3", B, 11)
    mus = _mus(B, 1)
    terr = _port_terrain(_jax_terrain())
    if route == "entry":
        got, gimp = tct.fb_step_ground_batched(
            tm, tuple(torch.from_numpy(x) for x in s[:5]),
            torch.from_numpy(s[5]), DT, links, offsets,
            mu=torch.from_numpy(mus), terrain=terr)
        for a, b, what in zip(got, nxt, OUTS):
            assert_close(a, b, what=what)
        assert_close(gimp, imp, what="impulses")
        return
    cols = [torch.from_numpy(x.T.copy()) for x in s]
    mu = torch.from_numpy(mus.T.copy())
    if route == "plain":
        out = tcf.step_ground_plain(tm, *cols, mu, DT, links, offsets,
                                    terrain=terr)
    else:
        out = tcf.step_ground_terrain_fused(tm, *cols, mu, DT, links,
                                            offsets, terr)
    for a, b, what in zip(out[:5], nxt, OUTS):
        assert_close(a.T, b, what=what)
    assert_close(out[5].T.reshape(B, 1, 3), imp, what="impulses")


@functools.cache
def _rollout_case():
    """A T = 3 rollout of the chain on the flat ground with a push
    schedule: numpy inputs and the JAX result."""
    jm, _ = _models("chain3")
    _, links, offsets = ROBOTS["chain3"]
    B, T = 6, 3
    s = _states("chain3", B, 11)
    rng = np.random.default_rng(33)
    taus = rng.uniform(-2, 2, (T, B, 3))
    f_bases = rng.uniform(-5, 5, (T, B, 6))
    final, imps = jct.fb_simulate_ground_batched(
        jm, tuple(jnp.asarray(x) for x in s[:5]), jnp.asarray(taus), DT,
        links, offsets, mu=0.7, impl="xla", f_bases=jnp.asarray(f_bases))
    return (s, taus, f_bases, tuple(np.asarray(x) for x in final),
            np.asarray(imps))


def test_rollout_matches_jax_and_single_steps():
    """fb_simulate_ground_batched against JAX's, and bit for bit against
    T single port steps."""
    s, taus, f_bases, final, imps = _rollout_case()
    _check_active(imps)
    _, tm = _models("chain3")
    _, links, offsets = ROBOTS["chain3"]
    state = tuple(torch.from_numpy(x) for x in s[:5])
    got, gimps = tct.fb_simulate_ground_batched(
        tm, state, torch.from_numpy(taus), DT, links, offsets, mu=0.7,
        f_bases=torch.from_numpy(f_bases))
    assert tuple(gimps.shape) == (3, 6, 1, 3)
    for a, b, what in zip(got, final, OUTS):
        assert_close(a, b, what=what)
    assert_close(gimps, imps, what="impulses")
    for t in range(taus.shape[0]):
        state, imp = tct.fb_step_ground_batched(
            tm, state, torch.from_numpy(taus[t]), DT, links, offsets,
            mu=0.7, f_base=torch.from_numpy(f_bases[t]))
        assert torch.equal(imp, gimps[t])
    assert all(torch.equal(a, b) for a, b in zip(state, got))


# ------------------------------------------------------------- helpers
@pytest.mark.parametrize("layout", ["scalar", "foot", "env", "env_foot",
                                    "tensor"])
def test_mu_layouts_match_jax(layout):
    """Every μ layout gives JAX's (k, B), and a step with it equals the
    step with that (k, B) array."""
    k, B = 4, 3
    mu = {"scalar": 0.7, "foot": np.asarray([0.5, 0.6, 0.7, 0.8]),
          "env": np.asarray([0.4, 0.9, 0.6]),
          "env_foot": _mus(B, k), "tensor": torch.tensor(0.65)}[layout]
    ref = np.asarray(jct._mu_to_bl(
        np.asarray(mu) if layout == "tensor" else mu, k, B, jnp.float64))
    got = tct._mu_to_bl(mu, k, B, torch.float64, torch.device("cpu"))
    assert got.is_contiguous()
    assert_close(got, ref, 0.0)


def test_mu_ambiguity_raises_as_jax():
    """A (k,) μ when B == k is refused with the JAX package's message."""
    with pytest.raises(ValueError) as ref:
        jct._mu_to_bl(np.ones(4), 4, 4, jnp.float64)
    with pytest.raises(ValueError) as got:
        tct._mu_to_bl(np.ones(4), 4, 4, torch.float64, torch.device("cpu"))
    assert str(got.value) == str(ref.value)
    _, tm = _models("hyq")
    _, links, offsets = ROBOTS["hyq"]
    s = [torch.from_numpy(x) for x in _states("hyq", 4, 7)]
    with pytest.raises(ValueError, match="ambiguous"):
        tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, links,
                                   offsets, mu=np.ones(4))


def test_step_helpers_match_jax():
    """joint_limit_torque, pd_torque, clamp_effort, project_joint_limits,
    soft_contact_params (and its error) and the per-row softness."""
    rng = np.random.default_rng(6)
    q, qd = rng.uniform(-1, 1, (5, 3)), rng.uniform(-1, 1, (5, 3))
    lo, hi = np.asarray([-0.5, -0.2, -np.inf]), np.asarray([0.4, 0.3, 0.5])
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    assert_close(tct.joint_limit_torque(tq, tqd, lo, hi),
                 jct.joint_limit_torque(q, qd, lo, hi), 1e-15)
    assert_close(tct.pd_torque(tq, tqd, 0.2, 30.0, 2.0, 0.1),
                 jct.pd_torque(q, qd, 0.2, 30.0, 2.0, 0.1), 1e-15)
    eff = np.asarray([0.3, np.inf, 0.5])
    assert_close(tct.clamp_effort(tqd, eff), jct.clamp_effort(qd, eff), 0.0)
    for a, b in zip(tct.project_joint_limits(tq, tqd, lo, hi),
                    jct.project_joint_limits(q, qd, lo, hi)):
        assert_close(a, b, 0.0)
    kp, kd = np.asarray([5e4, 1e4]), np.asarray([2e3, 0.0])
    for a, b in zip(tct.soft_contact_params(kp, kd, DT),
                    jct.soft_contact_params(kp, kd, DT)):
        assert_close(a, b, 0.0)
    with pytest.raises(ValueError, match="must be positive"):
        tct.soft_contact_params(0.0, 0.0, DT)
    assert_close(tcf._softness_rows(np.asarray([0.1, 0.2]), 2),
                 jct._softness_rows(np.asarray([0.1, 0.2]), 2, jnp.float64),
                 0.0)


# ------------------------------------------------------------- errors
UNPORTED = {
    "welds": (dict(welds=((), ())), "The rest of kinematics and contact"),
    "tendons": (dict(tendons=object()), "The rest of kinematics and contact"),
    "frictionloss": (dict(frictionloss=np.ones(3)),
                     "The rest of kinematics and contact"),
    "impulse_limits": (dict(limits=(np.zeros(3), np.ones(3)),
                            limit_mode="impulse"),
                       "The rest of kinematics and contact"),
    "implicit": (dict(diff_mode="implicit"),
                 "The rest of kinematics and contact"),
    "relax": (dict(relax=1.3), "The rest of kinematics and contact"),
    "vmap": (dict(impl="vmap"), "The per-state tier and differentiability"),
}


@pytest.mark.parametrize("option", list(UNPORTED))
def test_unported_options_raise(option):
    """Each option the slice does not port raises NotImplementedError
    naming its ROADMAP item by title."""
    kw, title = UNPORTED[option]
    _, tm = _models("chain3")
    _, links, offsets = ROBOTS["chain3"]
    s = [torch.from_numpy(x) for x in _states("chain3", 2, 1)]
    with pytest.raises(NotImplementedError) as e:
        tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, links,
                                   offsets, **kw)
    assert f"ROADMAP Queue 1, '{title}'" in str(e.value)
    rollout_kw = {k: v for k, v in kw.items() if k == "impl"}
    if rollout_kw:
        with pytest.raises(NotImplementedError, match=title):
            tct.fb_simulate_ground_batched(tm, tuple(s[:5]), s[5][None], DT,
                                           links, offsets, **rollout_kw)


def test_step_modes_and_shapes_raise():
    _, tm = _models("chain3")
    _, links, offsets = ROBOTS["chain3"]
    s = [torch.from_numpy(x) for x in _states("chain3", 2, 1)]
    for kw, msg in ((dict(limit_mode="spring"), "limit_mode must be"),
                    (dict(diff_mode="adjoint"), "diff_mode must be"),
                    (dict(impl="pallas"), "impl must be one of"),
                    (dict(impl="cuda"), "needs CUDA tensors"),
                    (dict(f_base=torch.zeros((2, 5))), r"f_base must be")):
        with pytest.raises(ValueError, match=msg):
            tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, links,
                                       offsets, **kw)
    with pytest.raises(ValueError, match=r"\(B, d\) states"):
        tct.fb_step_ground_batched(tm, tuple(x[0] for x in s[:5]), s[5][0],
                                   DT, links, offsets)
    with pytest.raises(ValueError, match="taus must be"):
        tct.fb_simulate_ground_batched(tm, tuple(s[:5]), s[5], DT, links,
                                       offsets)
    final, imps = tct.fb_simulate_ground_batched(
        tm, tuple(s[:5]), s[5][:0, None].expand(0, 2, 3), DT, links, offsets)
    assert tuple(imps.shape) == (0, 2, 1, 3)
    assert all(torch.equal(a, b) for a, b in zip(final, s[:5]))


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrappers and both entries run the plain version
    and launch nothing; the result is the plain version's."""
    _, tm = _models("chain3")
    _, links, offsets = ROBOTS["chain3"]
    s = _states("chain3", 3, 11)
    cols = [torch.from_numpy(x.T.copy()) for x in s]
    mu = torch.full((1, 3), 0.7, dtype=torch.float64)
    terr = _port_terrain(_jax_terrain())
    _launch.reset_launches()
    plain = tcf.step_ground_plain(tm, *cols, mu, DT, links, offsets)
    got = tcf.step_ground_fused(tm, *cols, mu, DT, links, offsets)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    tcf.step_ground_terrain_fused(tm, *cols, mu, DT, links, offsets, terr)
    state = tuple(torch.from_numpy(x) for x in s[:5])
    tct.fb_step_ground_batched(tm, state, torch.from_numpy(s[5]), DT, links,
                               offsets, terrain=terr)
    tct.fb_simulate_ground_batched(tm, state, torch.from_numpy(s[5])[None],
                                   DT, links, offsets)
    assert not any(_launch.LAUNCHES.values())
