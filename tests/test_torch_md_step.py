"""The port's multi-dof ground step and the free-flyer step's ground-geom
rows against the JAX package.

``md_step_ground_plain`` and ``md_step_ground_batched`` (CPU tensors: the
plain version), float64, against the JAX ``md_step_ground_batched(...,
impl="vmap")`` — its per-state reference, which the JAX package's own test
holds to its kernel body at these tolerances
(tests/test_md_contact.py:277-329) — on the ball ant from MJCF with its
torso sphere and per-environment μ (tests/test_md_contact.py's states,
seed 29), and on the free-jointed ball arm with the options (softness,
restitution, effort, projected limits). The free-flyer ``step_ground_plain``
with ground geoms against the JAX ``fb_step_ground_batched(impl="xla")`` on
the 3-link chain (a base sphere and a link capsule), flat and on a
heightfield. The port's md step against its free-flyer step on free HyQ
(two formulations of one physics). Each JAX reference is computed once
(never through interpret-mode Pallas). Also: the unported options'
errors, the limit check, the base-link error, and that CPU tensors launch
nothing.

Tolerances: the JAX test's own — 1e-11 on q⁺, 1e-10 on v⁺ and the
impulses (md), 1e-11 (the free-flyer step, as tests/test_torch_step.py);
md vs free flyer 1e-10 on v⁺ and the impulses (their configuration
updates differ at O(dt²): the md retraction moves the position with the
pre-update attitude).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu.ops import collision as jcol
from gridcodegenerator_tpu.ops import contact as jct
from gridcodegenerator_tpu.ops import freeflyer as jff
from gridcodegenerator_tpu.ops import md_contact as jmc
from gridcodegenerator_tpu.ops import multidof as jmd
from gridcodegenerator_tpu.ops import terrain as jtr
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import collision as tcol
from gridcodegenerator_tpu_torch.ops import contact as tct
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops import md_contact as tmc
from gridcodegenerator_tpu_torch.ops import multidof as tmd
from gridcodegenerator_tpu_torch.ops import terrain as ttr
from gridcodegenerator_tpu_torch.ops.kernels import _launch
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as tcf
from gridcodegenerator_tpu_torch.ops.kernels import md_contact_fused as tmcf

torch.set_num_threads(1)

DT_MD = 2e-3
DT = 1e-3
B = 4


def _close(got, want, atol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


# ------------------------------------------------------------ the ball ant
@functools.cache
def _ant():
    src = jzoo.ball_ant_mjcf()
    jm = jmd.multidof_model_from_description(g.parse_mjcf(src),
                                             dtype=jnp.float64)
    tm = gt.multidof_model_from_description(gt.parse_mjcf(tzoo.ball_ant_mjcf()),
                                            device="cpu")
    sites = gt.mjcf_sites(src)
    feet = tuple(sites[f"foot{k}"].link for k in range(4))
    offs = np.stack([sites[f"foot{k}"].pos for k in range(4)])
    return jm, tm, feet, offs


def _ant_states(jm, seed=29):
    """tests/test_md_contact.py:287-299: neutral q ⊕ a tangent step in
    U(±0.25), the base height in U(0, 0.15) (feet and torso in touch
    range), q̇ ± 0.4, τ ± 3, μ per environment in U(0.4, 1)."""
    rng = np.random.default_rng(seed)
    q0 = np.array(jmd.neutral_q(jm))
    qs, qds, taus = [], [], []
    for _ in range(B):
        d = rng.uniform(-0.25, 0.25, jm.nv)
        qe = np.array(jmd.md_tangent_apply(jm, jnp.asarray(q0),
                                           jnp.asarray(d)))
        qe[6] = rng.uniform(0.0, 0.15)
        qs.append(qe)
        qds.append(rng.uniform(-0.4, 0.4, jm.nv))
        taus.append(rng.uniform(-3, 3, jm.nv))
    mus = rng.uniform(0.4, 1.0, B)
    return np.stack(qs), np.stack(qds), np.stack(taus), mus


@functools.cache
def _ant_reference():
    """The JAX vmap step once, eager as the JAX test runs it (≈ 17 s):
    ((q⁺, v⁺), impulses)."""
    jm, _, feet, offs = _ant()
    qs, qds, taus, mus = _ant_states(jm)
    gg = jcol.make_geoms([0], a=[[0, 0, 0]], r=0.18, dtype=jnp.float64)
    (q2, v2), imp = jmc.md_step_ground_batched(
        jm, jnp.asarray(qs), jnp.asarray(qds), jnp.asarray(taus), DT_MD, feet,
        offs, mu=jnp.asarray(mus), ground_geoms=gg, mu_ground=0.6,
        impl="vmap")
    return np.asarray(q2), np.asarray(v2), np.asarray(imp)


def _torso():
    return tcol.make_geoms([0], a=[[0, 0, 0]], r=0.18, dtype=torch.float64,
                           device="cpu")


def test_md_plain_matches_jax_on_the_ball_ant():
    """md_step_ground_plain (feet then the torso sphere, per-environment μ
    and μ_ground 0.6) against the JAX vmap step; some contact carries a
    normal impulse."""
    jm, tm, feet, offs = _ant()
    qs, qds, taus, mus = _ant_states(jm)
    q_r, v_r, imp_r = _ant_reference()
    assert (imp_r[:, :, 2] > 1e-9).any(), "vacuous: no contact is pushed"
    mu = torch.cat([torch.from_numpy(mus)[None].expand(4, B),
                    torch.full((1, B), 0.6, dtype=torch.float64)])
    cols = [torch.from_numpy(x.T.copy()) for x in (qs, qds, taus)]
    q2, v2, imp = tmcf.md_step_ground_plain(
        tm, *cols, mu, DT_MD, feet, offs,
        ground_static=tcf.ground_geoms_static(_torso()))
    _close(q2.T, q_r, 1e-11)
    _close(v2.T, v_r, 1e-10)
    _close(imp.T.reshape(B, 5, 3), imp_r, 1e-10)


def test_md_entry_matches_jax_on_the_ball_ant():
    """The public md_step_ground_batched (B == k: μ per environment as (B,
    k)), and the wrapper on CPU tensors, equal the JAX step."""
    jm, tm, feet, offs = _ant()
    qs, qds, taus, mus = _ant_states(jm)
    q_r, v_r, imp_r = _ant_reference()
    _launch.reset_launches()
    (q2, v2), imp = gt.md_step_ground_batched(
        tm, *(torch.from_numpy(x) for x in (qs, qds, taus)), DT_MD, feet,
        offs, mu=torch.from_numpy(mus)[:, None].expand(B, 4),
        ground_geoms=_torso(), mu_ground=0.6)
    assert tuple(imp.shape) == (B, 5, 3)
    _close(q2, q_r, 1e-11)
    _close(v2, v_r, 1e-10)
    _close(imp, imp_r, 1e-10)
    assert not any(_launch.LAUNCHES.values())


# --------------------------------------------- the ball arm with options
ARM_FOOT = ((3,), np.asarray([[0.0, 0.0, -0.1]]))
ARM_ELBOW_Q = 11          # the elbow's slot: free 7 + shoulder ball 4


@functools.cache
def _arm():
    urdf = lambda z: z.with_free_joint(z.ball_arm(damping=0.1))
    jm = jmd.multidof_model_from_description(g.parse_urdf(urdf(jzoo)),
                                             dtype=jnp.float64)
    tm = gt.multidof_model_from_description(gt.parse_urdf(urdf(tzoo)),
                                            device="cpu")
    return jm, tm


def _arm_options(jm):
    erp, soft = jct.soft_contact_params(5e4, 2e3, DT_MD)
    lo, hi = np.full(jm.nq, -np.inf), np.full(jm.nq, np.inf)
    lo[ARM_ELBOW_Q], hi[ARM_ELBOW_Q] = -0.1, 0.1
    return dict(erp=float(erp), softness=float(soft), restitution=0.3,
                effort=np.full(jm.nv, 2.5), limits=(lo, hi), mu=0.8)


def test_md_options_match_jax_on_the_free_ball_arm():
    """A soft contact (erp, softness), restitution 0.3, an effort clamp and
    a projected elbow limit, with a sphere on the free base link: the
    port's entry against the JAX vmap step."""
    jm, tm = _arm()
    rng = np.random.default_rng(5)
    q0 = np.array(jmd.neutral_q(jm))
    qs = []
    for _ in range(B):
        qe = np.array(jmd.md_tangent_apply(
            jm, jnp.asarray(q0), jnp.asarray(rng.uniform(-0.1, 0.1, jm.nv))))
        qe[6] = 0.33 + rng.uniform(-0.02, 0.02)   # the hand at the ground
        qs.append(qe)
    qs = np.stack(qs)
    qds = rng.uniform(-0.5, 0.5, (B, jm.nv))
    taus = rng.uniform(-4, 4, (B, jm.nv))
    kw = _arm_options(jm)
    ga = dict(a=[[0.0, 0.0, -0.3]], r=0.15)
    (q_r, v_r), imp_r = jmc.md_step_ground_batched(
        jm, jnp.asarray(qs), jnp.asarray(qds), jnp.asarray(taus), DT_MD,
        *ARM_FOOT, impl="vmap", ground_z=-0.1,
        ground_geoms=jcol.make_geoms([0], dtype=jnp.float64, **ga), **kw)
    (q2, v2), imp = tmc.md_step_ground_batched(
        tm, *(torch.from_numpy(x) for x in (qs, qds, taus)), DT_MD,
        *ARM_FOOT, ground_z=-0.1,
        ground_geoms=tcol.make_geoms([0], dtype=torch.float64, device="cpu",
                                     **ga), **kw)
    assert (np.asarray(imp_r)[:, :, 2] > 1e-9).any(), "vacuous"
    _close(q2, q_r, 1e-11)
    _close(v2, v_r, 1e-10)
    _close(imp, imp_r, 1e-10)


# ------------------------------------------- md against the free flyer
def test_md_matches_the_free_flyer_step_on_hyq():
    """Free HyQ as a multi-dof robot (links shifted by its free joint) and
    as a free flyer: the two steps agree in v⁺ and the impulses (port
    only; the JAX package asserts the same, tests/test_md_contact.py:49)."""
    urdf = tzoo.hyq(damping=0.2)
    mdm = gt.multidof_model_from_description(
        gt.parse_urdf(tzoo.with_free_joint(urdf)), device="cpu")
    ffm = tff.free_flyer_model(gt.parse_urdf(urdf), device="cpu")
    feet = (2, 5, 8, 11)
    offs = np.tile([0.35, 0.0, 0.0], (4, 1))
    rng = np.random.default_rng(3)
    quat = rng.standard_normal((B, 4))
    quat = 0.9 * np.array([1.0, 0, 0, 0]) + 0.1 * (
        quat / np.linalg.norm(quat, axis=1, keepdims=True))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.c_[rng.uniform(-0.1, 0.1, (B, 2)), rng.uniform(0.3, 0.45, B)]
    q = np.tile([-0.1, 0.7, -1.2], (B, 4)) + rng.uniform(-0.1, 0.1, (B, 12))
    vb = rng.uniform(-0.4, 0.4, (B, 6))
    qd = rng.uniform(-0.4, 0.4, (B, 12))
    tau = rng.uniform(-8, 8, (B, 12))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    (q2, v2), imp_md = gt.md_step_ground_batched(
        mdm, t(np.c_[quat, pos, q]), t(np.c_[vb, qd]),
        t(np.c_[np.zeros((B, 6)), tau]), DT, tuple(l + 1 for l in feet),
        offs, mu=0.7)
    nxt, imp_ff = gt.fb_step_ground_batched(
        ffm, tuple(t(x) for x in (quat, pos, q, vb, qd)), t(tau), DT, feet,
        offs, mu=0.7)
    assert float(imp_ff[..., 2].max()) > 1e-9, "vacuous"
    _close(imp_md, imp_ff.numpy(), 1e-10)
    _close(v2[:, :6], nxt[3].numpy(), 1e-10)
    _close(v2[:, 6:], nxt[4].numpy(), 1e-10)
    _close(q2[:, 7:], nxt[2].numpy(), 1e-10)


# ----------------------------------------- free-flyer ground-geom rows
CHAIN = (lambda z: z.serial_chain(3, damping=0.1), (2,),
         np.asarray([[0.1, 0.0, 0.0]]))
CHAIN_GEOMS = dict(links=(-1, 1), a=[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                   b=[[0.0, 0.0, 0.0], [0.3, 0.0, 0.0]], r=[0.15, 0.05])


def _chain_states(seed):
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.c_[rng.uniform(-0.1, 0.1, (B, 2)), rng.uniform(0.0, 0.2, B)]
    return [quat, pos, rng.uniform(-0.5, 0.5, (B, 3)),
            rng.uniform(-0.5, 0.5, (B, 6)), rng.uniform(-0.5, 0.5, (B, 3)),
            rng.uniform(-5, 5, (B, 3))]


@pytest.mark.parametrize("ground", ["flat", "terrain"])
def test_ff_geom_rows_match_jax(ground):
    """step_ground_plain with a base sphere and a link capsule (three
    contacts after the foot), per-environment μ and μ_ground 0.6, flat and
    on a heightfield, and the entry with the same geoms: against the JAX
    fb_step_ground_batched(impl="xla")."""
    urdf, links, offs = CHAIN
    jm = jff.free_flyer_model(g.parse_urdf(urdf(jzoo)), dtype=jnp.float64)
    tm = tff.free_flyer_model(gt.parse_urdf(urdf(tzoo)), device="cpu")
    s = _chain_states(5)
    mus = np.random.default_rng(6).uniform(0.4, 1.0, B)
    jt = tt = None
    if ground == "terrain":
        jt = jtr.bumpy_terrain(amp=0.05, wavelength=0.9, extent=2.0,
                               cell=0.25, rough=0.02, dtype=jnp.float64)
        tt = ttr.make_terrain(np.asarray(jt.heights), np.asarray(jt.origin),
                              jt.cell, dtype=torch.float64, device="cpu")
    gl = CHAIN_GEOMS["links"]
    geo = {k: v for k, v in CHAIN_GEOMS.items() if k != "links"}
    nxt_r, imp_r = jct.fb_step_ground_batched(
        jm, tuple(jnp.asarray(x) for x in s[:5]), jnp.asarray(s[5]), DT,
        links, offs, mu=jnp.asarray(mus), terrain=jt, impl="xla",
        ground_geoms=jcol.make_geoms(gl, dtype=jnp.float64, **geo),
        mu_ground=0.6)
    assert (np.asarray(imp_r)[:, 1:, 2] > 1e-9).any(), "vacuous geoms"
    tg = tcol.make_geoms(gl, dtype=torch.float64, device="cpu", **geo)
    static = tcf.ground_geoms_static(tg)
    assert [c[0] for c in static] == [-1, 1, 1]
    mu = torch.cat([torch.from_numpy(mus)[None],
                    torch.full((3, B), 0.6, dtype=torch.float64)])
    cols = [torch.from_numpy(x.T.copy()) for x in s]
    out = tcf.step_ground_plain(tm, *cols, mu, DT, links, offs, terrain=tt,
                                ground_static=static)
    for got, want in zip(out[:5], nxt_r):
        _close(got.T, want, 1e-11)
    _close(out[5].T.reshape(B, 4, 3), imp_r, 1e-11)
    nxt, imp = tct.fb_step_ground_batched(
        tm, tuple(torch.from_numpy(x) for x in s[:5]),
        torch.from_numpy(s[5]), DT, links, offs, mu=torch.from_numpy(mus),
        terrain=tt, ground_geoms=tg, mu_ground=0.6)
    for got, want in zip((*nxt, imp), (*nxt_r, imp_r)):
        _close(got, want, 1e-11)


def test_geom_mu_defaults_to_mu_per_environment():
    """mu_ground=None: the geom rows take each environment's μ (the JAX
    XLA body's rule); a scalar gives every row the same value."""
    mu = tct._contact_mu(torch.tensor([0.3, 0.5, 0.7], dtype=torch.float64),
                         None, 2,
                         ((0, (0.0,) * 3, 0.1),), 3, torch.float64, "cpu")
    assert torch.equal(mu, torch.tensor([[0.3, 0.5, 0.7]] * 3,
                                        dtype=torch.float64))
    mu = tct._contact_mu(0.9, 0.6, 2, ((0, (0.0,) * 3, 0.1),) * 2, 3,
                         torch.float64, "cpu")
    assert torch.equal(mu[2:], torch.full((2, 3), 0.6, dtype=torch.float64))


def test_geom_rollout_equals_its_steps():
    """fb_simulate_ground_batched with ground geoms equals T single
    steps, bit for bit."""
    urdf, links, offs = CHAIN
    tm = tff.free_flyer_model(gt.parse_urdf(urdf(tzoo)), device="cpu")
    s = [torch.from_numpy(x) for x in _chain_states(8)]
    tg = tcol.make_geoms(CHAIN_GEOMS["links"], dtype=torch.float64,
                         device="cpu", **{k: v for k, v in
                                          CHAIN_GEOMS.items()
                                          if k != "links"})
    taus = s[5][None].expand(3, -1, -1)
    final, imps = tct.fb_simulate_ground_batched(
        tm, tuple(s[:5]), taus, DT, links, offs, ground_geoms=tg,
        mu_ground=0.6)
    assert tuple(imps.shape) == (3, B, 4, 3)
    state = tuple(s[:5])
    for t in range(3):
        state, imp = tct.fb_step_ground_batched(
            tm, state, taus[t], DT, links, offs, ground_geoms=tg,
            mu_ground=0.6)
        assert torch.equal(imp, imps[t])
    assert all(torch.equal(a, b) for a, b in zip(state, final))


# ------------------------------------------------------ errors, routing
MD_UNPORTED = {
    "terrain": (dict(terrain=object()), "The rest of kinematics and contact"),
    "impulse_limits": (dict(limit_mode="impulse"),
                       "The rest of kinematics and contact"),
    "loops": (dict(loops=((), (), ())), "The rest of kinematics and contact"),
    "welds": (dict(welds=((), ())), "The rest of kinematics and contact"),
    "tendons": (dict(tendons=object()), "The rest of kinematics and contact"),
    "frictionloss": (dict(frictionloss=np.ones(13)),
                     "The rest of kinematics and contact"),
    "implicit": (dict(diff_mode="implicit"),
                 "The rest of kinematics and contact"),
    "relax": (dict(relax=1.3), "The rest of kinematics and contact"),
    "vmap": (dict(impl="vmap"), "The per-state tier and differentiability"),
}


def _arm_call(**kw):
    _, tm = _arm()
    q = tmd.neutral_q(tm).expand(2, -1).clone()
    v = torch.zeros((2, tm.nv), dtype=torch.float64)
    return tmc.md_step_ground_batched(tm, q, v, v, DT_MD, *ARM_FOOT, **kw)


@pytest.mark.parametrize("option", list(MD_UNPORTED))
def test_md_unported_options_raise(option):
    kw, title = MD_UNPORTED[option]
    if option == "impulse_limits":
        jm, _ = _arm()
        kw = dict(kw, limits=_arm_options(jm)["limits"])
    with pytest.raises(NotImplementedError) as e:
        _arm_call(**kw)
    assert f"ROADMAP Queue 1, '{title}'" in str(e.value)


def test_md_limit_and_geom_errors():
    """A finite limit on a ball or free slot raises (the JAX message); a
    geom on link −1 raises the JAX md error (no base link); mode errors."""
    jm, tm = _arm()
    lo, hi = np.full(jm.nq, -np.inf), np.full(jm.nq, np.inf)
    lo[8] = -0.2                      # the shoulder quaternion's x
    msgs = []
    for fn, m in ((jmc._md_check_limits, jm), (tmc._md_check_limits, tm)):
        with pytest.raises(ValueError) as e:
            fn(m, lo, hi)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "[8]" in msgs[0]
    with pytest.raises(ValueError) as e:
        _arm_call(ground_geoms=tcol.make_geoms(
            [-1], a=[[0, 0, 0]], dtype=torch.float64, device="cpu"))
    q = jnp.asarray(np.array(jmd.neutral_q(jm)))
    with pytest.raises(ValueError) as je:
        jmc.md_contact_rows(jm, q, *ARM_FOOT, geoms=jcol.make_geoms(
            [-1], a=[[0, 0, 0]], dtype=jnp.float64))
    assert str(e.value) == str(je.value)
    for kw, msg in ((dict(limit_mode="spring"), "limit_mode must be"),
                    (dict(diff_mode="adjoint"), "diff_mode must be"),
                    (dict(impl="cuda"), "needs CUDA tensors")):
        with pytest.raises(ValueError, match=msg):
            _arm_call(**kw)


def test_ff_geom_link_error_matches_jax():
    urdf, links, offs = CHAIN
    tm = tff.free_flyer_model(gt.parse_urdf(urdf(tzoo)), device="cpu")
    s = [torch.from_numpy(x) for x in _chain_states(1)]
    bad = tcol.make_geoms([3], a=[[0, 0, 0]], dtype=torch.float64,
                          device="cpu")
    with pytest.raises(ValueError,
                       match=r"ground-geom links \[3\] out of range \[-1, 3\)"):
        tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, links, offs,
                                   ground_geoms=bad)


def test_md_cpu_tensors_run_the_plain_version():
    """On CPU tensors the md wrapper and entry run the plain version and
    launch nothing; the build key of the md step carries the contact
    links, feet then geoms."""
    from gridcodegenerator_tpu_torch.ops.kernels import _build
    _, tm, feet, offs = _ant()
    q = tmd.md_tangent_apply(tm, tmd.neutral_q(tm).expand(2, -1),
                             torch.full((2, tm.nv), 0.05,
                                        dtype=torch.float64))
    v = torch.full((2, tm.nv), 0.1, dtype=torch.float64)
    cols = [x.T.contiguous() for x in (q, v, v)]
    mu = torch.full((5, 2), 0.7, dtype=torch.float64)
    static = tcf.ground_geoms_static(_torso())
    _launch.reset_launches()
    plain = tmcf.md_step_ground_plain(tm, *cols, mu, DT_MD, feet, offs,
                                      ground_static=static)
    got = tmcf.md_step_ground_fused(tm, *cols, mu, DT_MD, feet, offs,
                                    ground_geoms=_torso())
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert not any(_launch.LAUNCHES.values())
    key = _build.topology_key(tm, feet + (0,))
    assert key == _build.topology_key(tm) + (feet + (0,),)
    assert _build._units(key) == ("md_step.cu",)
    macros = _build._macros(key)
    assert "-DGRID_MD_K=5" in macros
    assert "-DGRID_MD_LINKS=G(2)G(4)G(6)G(8)G(0)" in macros
    assert _build._digest(key) != _build._digest(_build.topology_key(tm))
