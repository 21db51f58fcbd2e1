"""The ground stepper's collision and loop-closure rows against the JAX
package.

The port's collision rows (``ops/collision.fb_collision_rows_bl``,
``fb_collision_distances``, ``kernels/contact_fused.collision_static``) and
loop rows (``ops/loops._fb_loop_rows_bl``, ``fb_loop_gap``) against the
JAX ones; ``step_ground_plain``, the ``step_ground_fused`` /
``step_ground_terrain_fused`` wrappers on CPU tensors and the public
``fb_step_ground_batched`` / ``fb_simulate_ground_batched`` with
``collision=``, ``mu_collision=`` and ``loops=`` against the JAX
``fb_step_ground_batched(impl="xla")`` — its batch-last XLA body, eager, which the JAX package's own tests hold to its interpret-mode
kernel (tests/test_contact_fused.py:308, :363) — each computed once, float64.

Cases: HyQ with fat leg capsules and a sphere obstacle (the JAX test's,
r 0.24 and 0.35, its states of seed 17), where self and obstacle pairs
both carry impulse; the same legs with a base capsule (link −1) in self
pairs and a slanted capsule obstacle (rows only: a vertical capsule puts
the normals at n_z = 0, where the frame flips with one ulp); the four-bar
as a free flyer with its closure and a world pin on the crank, ground
contact active (60 sweeps, μ 0.7); one case with collision, ground geoms,
loops, softness and a push together on a heightfield; a rollout with
loops against its single steps; every μ layout of ``mu_collision``; the
JAX package's errors for bad loop pairs and bad geoms; and the build key.

Tolerances: the JAX test's own — states 1e-11 (the loop step 1e-10),
impulses 1e-10; rows and gaps 1e-12 — each relative to max(1, the
largest entry of the reference output) (:func:`assert_close`).
"""

import functools

import jax
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
from gridcodegenerator_tpu.ops import loops as jlp
from gridcodegenerator_tpu.ops import terrain as jtr
from gridcodegenerator_tpu.ops.kernels import contact_fused as jcf
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import collision as tcol
from gridcodegenerator_tpu_torch.ops import contact as tct
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops import loops as tlp
from gridcodegenerator_tpu_torch.ops import terrain as ttr
from gridcodegenerator_tpu_torch.ops.kernels import _build, _launch
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as tcf

torch.set_num_threads(1)

DT = 1e-3
FEET = (2, 5, 8, 11)
FOFF = np.tile([0.35, 0.0, 0.0], (4, 1))
OUTS = ("quat", "pos", "q", "vb", "qd")
F64 = torch.float64


def _hyq_states(B, seed):
    """tests/test_contact_fused.py's ``_states``."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.5]
    q = np.tile([-0.1, 0.7, -1.2], (B, 4)) + rng.uniform(-0.1, 0.1, (B, 12))
    vb = rng.uniform(-0.6, 0.6, (B, 6))
    qd = rng.uniform(-0.5, 0.5, (B, 12))
    tau = rng.uniform(-10, 10, (B, 12))
    return [quat, pos, q, vb, qd, tau]


def _four_bar_states(n, B, seed):
    """tests/test_contact_fused.py's loop-step states: near the ground."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.concatenate([rng.uniform(-0.2, 0.2, (B, 2)),
                          rng.uniform(0.2, 0.3, (B, 1))], axis=1)
    return [quat, pos, rng.uniform(-0.2, 0.2, (B, n)),
            rng.uniform(-1, 1, (B, 6)), rng.uniform(-1, 1, (B, n)),
            rng.uniform(-1, 1, (B, n))]


@functools.cache
def _models(name):
    urdf = {"hyq": lambda z: z.hyq(damping=0.2),
            "four_bar": lambda z: z.four_bar(damping=0.05)}[name]
    jm = jff.free_flyer_model(g.parse_urdf(urdf(jzoo)), dtype=jnp.float64)
    tm = tff.free_flyer_model(gt.parse_urdf(urdf(tzoo)), device="cpu")
    return jm, tm


# collision sets: name → (geoms (links, a, b, r), obstacles (a, b, r))
LEGS = ((2, 5, 8, 11), np.zeros((4, 3)), np.tile([0.3, 0.0, 0.0], (4, 1)),
        0.24)
SETS = {
    # the JAX test's: fat leg capsules and a sphere obstacle
    "legs": (LEGS, ([[0.25, 0.05, 0.1]], None, 0.35)),
    # plus a base capsule (link −1) and a slanted capsule obstacle
    "rich": (((2, 5, 8, 11, -1),
              np.concatenate([np.zeros((4, 3)), [[-0.3, 0.0, -0.05]]]),
              np.concatenate([np.tile([0.3, 0.0, 0.0], (4, 1)),
                              [[0.3, 0.05, 0.0]]]),
              np.asarray([0.24, 0.24, 0.24, 0.24, 0.15])),
             ([[0.25, 0.05, 0.1], [-0.5, -0.4, -0.1]],
              [[0.25, 0.05, 0.1], [0.4, 0.3, 0.3]], [0.35, 0.2])),
}


@functools.cache
def _collision(name, side):
    (links, a, b, r), (oa, ob, orr) = SETS[name]
    jm, tm = _models("hyq")
    if side == "jax":
        geoms = jcol.make_geoms(links, a, b, r, dtype=jnp.float64)
        obs = jcol.make_obstacles(oa, ob, orr, dtype=jnp.float64)
        return jcol.make_collision_model(geoms, topology=jm.arm.topology,
                                         obstacles=obs, min_separation=2)
    geoms = tcol.make_geoms(links, a, b, r, dtype=F64, device="cpu")
    obs = tcol.make_obstacles(oa, ob, orr, dtype=F64, device="cpu")
    return tcol.make_collision_model(geoms, topology=tm.arm.topology,
                                     obstacles=obs, min_separation=2)


def _four_bar_loops():
    """The JAX test's closure (coupler, rocker) and a world pin on the
    crank tip, and feet on the rocker and the crank."""
    names = g.parse_urdf(jzoo.four_bar()).topology.link_names
    crank, coupler, rocker = (names.index(x) for x in ("crank", "coupler",
                                                       "rocker"))
    loops = (((coupler, rocker), (crank, -1)),
             np.array([[0.8, 0.0, 0.0], [0.0, 0.0, -0.25]]),
             np.array([[0.0, 0.0, -0.5], [0.1, 0.0, 0.15]]))
    return loops, (rocker, crank), np.array([[0.0, 0.0, -0.25]] * 2)


def _jax_step(name, s, links, offsets, **kw):
    """The JAX XLA body, eager: for HyQ's 42 rows jit's trace and compile
    cost more than eager dispatch (≈ 80 s against ≈ 30 s on one core)."""
    jm, _ = _models(name)
    nxt, imp = jct.fb_step_ground_batched(
        jm, tuple(jnp.asarray(x) for x in s[:5]), jnp.asarray(s[5]), DT,
        links, offsets, impl="xla", **kw)
    return tuple(np.asarray(x) for x in nxt), np.asarray(imp)


@functools.cache
def _jax_collision_step():
    s = _hyq_states(4, 17)
    return s, _jax_step("hyq", s, FEET, FOFF, mu=0.8,
                        collision=_collision("legs", "jax"),
                        mu_collision=0.45)


@functools.cache
def _jax_loop_step():
    loops, links, offs = _four_bar_loops()
    s = _four_bar_states(3, 4, 23)
    return s, _jax_step("four_bar", s, links, offs, mu=0.7, iters=60,
                        loops=loops)


def assert_close(got, ref, tol, what=""):
    """max |got − ref| ≤ tol · max(1, max |ref|): the deep contacts here
    drive q̇ to O(400) rad/s and impulses to O(1e3), where the PGS sweeps
    amplify the round-off of two orderings of the same sums (the port's
    Delassus is its lower triangle read both ways, as the kernel's; the XLA
    body forms both triangles) to ≈ 1e-11 absolute, 3e-14 relative."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    assert err <= tol * scale, f"{what}: max err {err:.3e} (scale {scale:.3g})"


def _bl(x):
    return torch.from_numpy(np.ascontiguousarray(x.T))


def _run(route, name, s, links, offsets, mu_bl, **kw):
    """One port step by ``route`` → (next state batch first, impulses (B,
    k_t, 3)); ``mu_bl`` the (k_t, B) μ of the batch-last routes, and for
    the entry ``kw`` carries μ in the user's layout."""
    _, tm = _models(name)
    B = s[0].shape[0]
    if route == "entry":
        return tct.fb_step_ground_batched(
            tm, tuple(torch.from_numpy(x) for x in s[:5]),
            torch.from_numpy(s[5]), DT, links, offsets, **kw)
    kw = {k: v for k, v in kw.items()
          if k not in ("mu", "mu_collision", "mu_ground")}
    terrain = kw.pop("terrain", None)
    if route == "plain":
        kw["collision_static"] = tcf.collision_static(kw.pop("collision",
                                                             None))
        kw["loop_static"] = tcf.loops_static(tm.n, kw.pop("loops", None))
        kw["ground_static"] = tcf.ground_geoms_static(kw.pop("ground_geoms",
                                                             None))
        out = tcf.step_ground_plain(tm, *(_bl(x) for x in s), mu_bl, DT,
                                    links, offsets, terrain=terrain, **kw)
    elif terrain is None:
        out = tcf.step_ground_fused(tm, *(_bl(x) for x in s), mu_bl, DT,
                                    links, offsets, **kw)
    else:
        out = tcf.step_ground_terrain_fused(tm, *(_bl(x) for x in s), mu_bl,
                                            DT, links, offsets, terrain,
                                            **kw)
    return (tuple(x.T for x in out[:5]),
            out[5].T.reshape(B, -1, 3))


# ------------------------------------------------------------- the rows
@pytest.mark.parametrize("name", list(SETS))
def test_collision_static_matches_jax(name):
    """The static form's geometry and pairs equal the JAX
    ``collision_static``'s; the set keeps it (no read-back a step)."""
    ref = jcf.collision_static(_collision(name, "jax"))
    cm = _collision(name, "port")
    cs = tcf.collision_static(cm)
    assert cs is cm.static
    assert cs.pairs == ref["pairs"] and cs.obs_pairs == ref["obs_pairs"]
    assert tuple(l for l, *_ in cs.geoms) == ref["links"]
    for key, col in (("a", 1), ("d", 2), ("r", 3)):
        assert_close(np.asarray([gm[col] for gm in cs.geoms]), ref[key], 0.0)
    for key, col in (("obs_a", 0), ("obs_d", 1), ("obs_r", 2)):
        assert_close(np.asarray([o[col] for o in cs.obstacles]), ref[key],
                     0.0)


@pytest.mark.parametrize("name", list(SETS))
def test_collision_rows_match_jax(name):
    """fb_collision_rows_bl and fb_collision_distances against the JAX
    fb_collision_rows_bl on HyQ's states: every gap and row, and both
    kinds of pair present (the base geom's self pairs in ``rich``)."""
    jm, tm = _models("hyq")
    s = _hyq_states(6, 17)
    jcm, tcm = _collision(name, "jax"), _collision(name, "port")
    gaps_r, J_r = jcol.fb_collision_rows_bl(
        jm, *(jnp.asarray(x.T) for x in s[:3]), jcm)
    args = [_bl(x) for x in s[:3]]
    gaps, J = tcol.fb_collision_rows_bl(tm, *args, tcm)
    assert_close(gaps, gaps_r, 1e-12, "gaps")
    assert_close(J, J_r, 1e-12, "rows")
    assert_close(tcol.fb_collision_distances(tm, *args, tcm), gaps_r, 1e-12)
    assert tcm.pairs and tcm.obs_pairs
    if name == "rich":
        assert any(-1 in (tcm.geoms.links[i], tcm.geoms.links[j])
                   for i, j in tcm.pairs)


def test_loop_rows_match_jax():
    """_fb_loop_rows_bl and fb_loop_gap against the JAX ones (the JAX gap
    is per state: vmapped) for a link↔link closure and a world pin."""
    jm, tm = _models("four_bar")
    loops, _, _ = _four_bar_loops()
    s = _four_bar_states(3, 6, 23)
    J_r, xa_r, xb_r = jlp._fb_loop_rows_bl(
        jm, jnp.asarray(s[0].T), jnp.asarray(s[2].T), loops[0],
        jnp.asarray(loops[1]), jnp.asarray(loops[2]))
    J, xa, xb = tlp._fb_loop_rows_bl(tm, _bl(s[0]), _bl(s[2]), *loops)
    assert_close(J, J_r, 1e-12, "rows")
    for a, b in zip(xa, xa_r):
        assert_close(a, b, 1e-12, "x_a")
    assert xb[1] is None and xb_r[1] is None
    assert_close(xb[0], xb_r[0], 1e-12, "x_b")
    gap_r = jax.vmap(lambda qt, p, q: jlp.fb_loop_gap(jm, qt, p, q, *loops))(
        *(jnp.asarray(x) for x in s[:3]))
    gap = tlp.fb_loop_gap(tm, *(_bl(x) for x in s[:3]), *loops)
    assert_close(gap.T, gap_r, 1e-12, "gap")


# ------------------------------------------------------------- the steps
@pytest.mark.parametrize("route", ["plain", "wrapper", "entry"])
def test_collision_step_matches_jax(route):
    """HyQ's feet with the fat legs and the sphere, μ 0.8 and
    μ_collision 0.45: states 1e-11, impulses 1e-10; self and obstacle
    triplets both carry impulse."""
    s, (nxt, imp) = _jax_collision_step()
    kc = len(_collision("legs", "port").pairs)
    assert (imp[:, 4:4 + kc, 2] > 1e-9).any()
    assert (imp[:, 4 + kc:, 2] > 1e-9).any()
    mu_bl = torch.cat([torch.full((4, 4), 0.8, dtype=F64),
                       torch.full((10, 4), 0.45, dtype=F64)])
    got, gimp = _run(route, "hyq", s, FEET, FOFF, mu_bl, mu=0.8,
                     collision=_collision("legs", "port"), mu_collision=0.45)
    for a, b, what in zip(got, nxt, OUTS):
        assert_close(a, b, 1e-11, what)
    assert_close(gimp, imp, 1e-10, "impulses")


@pytest.mark.parametrize("route", ["plain", "wrapper", "entry"])
def test_loop_step_matches_jax(route):
    """The four-bar with its closure and a world pin, 60 sweeps, μ 0.7,
    ground contact active: 1e-10."""
    s, (nxt, imp) = _jax_loop_step()
    assert (imp[..., 2] > 1e-9).any(), "no active ground contact"
    loops, links, offs = _four_bar_loops()
    got, gimp = _run(route, "four_bar", s, links, offs,
                     torch.full((2, 4), 0.7, dtype=F64), mu=0.7, iters=60,
                     loops=loops)
    for a, b, what in zip(got, nxt, OUTS):
        assert_close(a, b, 1e-10, what)
    assert_close(gimp, imp, 1e-10, "impulses")


@functools.cache
def _terrains():
    jt = jtr.bumpy_terrain(amp=0.05, wavelength=0.9, extent=2.0, cell=0.25,
                           rough=0.02, dtype=jnp.float64)
    tt = ttr.make_terrain(np.asarray(jt.heights), np.asarray(jt.origin),
                          jt.cell, dtype=F64, device="cpu")
    return jt, tt


# the four-bar's ground geoms: a torso capsule on the base, a sphere
# on the coupler
COMBINED_GEOMS = ((-1, 1), [[-0.2, 0.0, 0.0], [0.4, 0.0, 0.0]],
                  [[0.6, 0.0, 0.0], [0.4, 0.0, 0.0]], [0.06, 0.05])


@functools.cache
def _four_bar_collision(side):
    """A self pair of fat capsules on the crank and the rocker and a sphere
    obstacle beside the linkage (1 + 2 contacts)."""
    mod, kw = ((jcol, dict(dtype=jnp.float64)) if side == "jax"
               else (tcol, dict(dtype=F64, device="cpu")))
    geoms = mod.make_geoms((0, 2), [[0.0, 0.0, -0.1]] * 2,
                           [[0.0, 0.0, -0.45]] * 2, 0.42, **kw)
    return mod.make_collision_model(
        geoms, pairs=((0, 1),),
        obstacles=mod.make_obstacles([[0.4, 0.1, -0.1]], r=0.15, **kw))


@functools.cache
def _combined_case():
    """The four-bar's collision set, two ground geoms, its loops, a soft
    contact and a push, on a heightfield."""
    loops, links, offs = _four_bar_loops()
    s = _four_bar_states(3, 4, 29)
    s[1][:, 2] -= 0.05
    erp, soft = jct.soft_contact_params(5e4, 2e3, DT)
    push = np.random.default_rng(5).uniform(-10, 10, (4, 6))
    side = {}
    for tag, mod, ter, kw in (
            ("jax", jcol, _terrains()[0], dict(dtype=jnp.float64)),
            ("port", tcol, _terrains()[1], dict(dtype=F64, device="cpu"))):
        side[tag] = dict(collision=_four_bar_collision(tag),
                         ground_geoms=mod.make_geoms(*COMBINED_GEOMS, **kw),
                         terrain=ter, loops=loops, mu=0.7, mu_collision=0.5,
                         mu_ground=0.6, erp=float(erp), softness=float(soft))
    ref = _jax_step("four_bar", s, links, offs, f_base=jnp.asarray(push),
                    **side["jax"])
    return s, push, side["port"], ref


@pytest.mark.parametrize("route", ["plain", "entry"])
def test_combined_case_matches_jax(route):
    """Collision, ground geoms, loops, softness and a push together on the
    heightfield: every block in one Delassus operator."""
    s, push, kw, (nxt, imp) = _combined_case()
    loops, links, offs = _four_bar_loops()
    assert imp.shape == (4, 2 + 3 + 3, 3)
    act = (imp[..., 2] > 1e-9).any(axis=0)
    assert act[0] and act[2:5].all() and act[5:].any(), act
    kw = dict(kw)
    if route == "entry":
        got, gimp = _run(route, "four_bar", s, links, offs, None,
                         f_base=torch.from_numpy(push), **kw)
    else:
        mu_bl = torch.cat([torch.full((2, 4), 0.7, dtype=F64),
                           torch.full((3, 4), 0.5, dtype=F64),
                           torch.full((3, 4), 0.6, dtype=F64)])
        got, gimp = _run(route, "four_bar", s, links, offs, mu_bl,
                         push=_bl(push), **kw)
    for a, b, what in zip(got, nxt, OUTS):
        assert_close(a, b, 1e-10, what)
    assert_close(gimp, imp, 1e-10, "impulses")


def test_loop_rollout_equals_its_steps():
    """fb_simulate_ground_batched with loops equals T single steps, bit
    for bit, and keeps the closure gap small."""
    _, tm = _models("four_bar")
    loops, links, offs = _four_bar_loops()
    s = _four_bar_states(3, 4, 23)
    state = tuple(torch.from_numpy(x) for x in s[:5])
    taus = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1,
                                                             (3, 4, 3)))
    final, imps = tct.fb_simulate_ground_batched(
        tm, state, taus, DT, links, offs, mu=0.7, loops=loops)
    assert tuple(imps.shape) == (3, 4, 2, 3)
    for t in range(3):
        state, imp = tct.fb_step_ground_batched(tm, state, taus[t], DT, links,
                                                offs, mu=0.7, loops=loops)
        assert torch.equal(imp, imps[t])
    assert all(torch.equal(a, b) for a, b in zip(state, final))


# ------------------------------------------------------------- μ layouts
@pytest.mark.parametrize("layout", ["scalar", "env", "contact"])
def test_mu_collision_layouts_match_jax(layout):
    """μ_collision as a scalar, per environment (B,) and per environment
    and contact (B, k_c), on the four-bar's collision set: the port's step
    against the JAX XLA body with the same layout."""
    s = _four_bar_states(3, 4, 29)
    _, links, offs = _four_bar_loops()
    rng = np.random.default_rng(12)
    muc = {"scalar": 0.45, "env": rng.uniform(0.3, 0.9, 4),
           "contact": rng.uniform(0.3, 0.9, (4, 3))}[layout]
    nxt, imp = _jax_step("four_bar", s, links, offs, mu=0.8,
                         collision=_four_bar_collision("jax"),
                         mu_collision=jnp.asarray(muc))
    assert (np.abs(imp[:, 2:, :2]) > 1e-9).any(), "no collision friction"
    got, gimp = _run("entry", "four_bar", s, links, offs, None, mu=0.8,
                     collision=_four_bar_collision("port"),
                     mu_collision=(muc if layout == "scalar"
                                   else torch.from_numpy(muc)))
    for a, b, what in zip(got, nxt, OUTS):
        assert_close(a, b, 1e-11, what)
    assert_close(gimp, imp, 1e-10, "impulses")


def test_mu_collision_defaults_to_mu():
    """mu_collision=None: the collision rows take each environment's μ;
    a (B, k) μ cannot serve them and raises, naming mu_collision."""
    mu = tct._contact_mu(torch.tensor([0.3, 0.5, 0.7], dtype=F64), None, 2,
                         (), 3, F64, "cpu", kc=2)
    assert torch.equal(mu, torch.tensor([[0.3, 0.5, 0.7]] * 4, dtype=F64))
    with pytest.raises(ValueError, match="pass mu_collision"):
        tct._contact_mu(torch.ones((3, 2), dtype=F64), None, 2, (), 3, F64,
                        "cpu", kc=4)


# ------------------------------------------------------------- errors
LOOP_ERRORS = {
    "empty": ((), np.zeros((0, 3)), np.zeros((0, 3))),
    "a_range": (((7, 1),), np.zeros((1, 3)), np.zeros((1, 3))),
    "b_range": (((0, -2),), np.zeros((1, 3)), np.zeros((1, 3))),
    "self": (((1, 1),), np.zeros((1, 3)), np.zeros((1, 3))),
    "shape": (((0, 1),), np.zeros((2, 3)), np.zeros((1, 3))),
}


@pytest.mark.parametrize("case", list(LOOP_ERRORS))
def test_bad_loops_raise_as_jax(case):
    loops = LOOP_ERRORS[case]
    with pytest.raises(ValueError) as ref:
        jlp._check_fb_pairs(3, *loops)
    _, tm = _models("four_bar")
    _, links, offs = _four_bar_loops()
    s = [torch.from_numpy(x) for x in _four_bar_states(3, 2, 1)]
    with pytest.raises(ValueError) as got:
        tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, links, offs,
                                   loops=loops)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["link", "pair", "obstacle"])
def test_bad_geoms_raise_as_jax(case):
    """A geom link out of range, a self pair and an obstacle pair out of
    range: the step raises the JAX package's _check_geoms message."""
    msgs = []
    for mod, kw in ((jcol, dict(dtype=jnp.float64)),
                    (tcol, dict(dtype=F64, device="cpu"))):
        geoms = mod.make_geoms((1, 7 if case == "link" else 2),
                               [[0.0, 0.0, 0.0]] * 2, r=0.1, **kw)
        obs = mod.make_obstacles([[0.0, 0.0, 0.0]], r=0.1, **kw)
        cm = mod.make_collision_model(
            geoms, pairs=((0, 3),) if case == "pair" else ((0, 1),),
            obstacles=obs,
            obs_pairs=((0, 2),) if case == "obstacle" else ((0, 0),))
        with pytest.raises(ValueError) as e:
            if mod is jcol:
                mod._check_geoms(3, cm)
            else:
                _, tm = _models("four_bar")
                _, links, offs = _four_bar_loops()
                s = [torch.from_numpy(x)
                     for x in _four_bar_states(3, 2, 1)]
                tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, links,
                                           offs, collision=cm)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- the kernel
def test_build_key_holds_links_not_geometry():
    """The step library's key holds the collision pairs' links (−2 for an
    obstacle) and the loops' links, not their geometry: two geometries on
    the same links share one library."""
    _, tm = _models("hyq")
    cs = tcf.collision_static(_collision("legs", "port"))
    pairs = (tcf.collision_links(cs), ((2, -1),))
    key = _build.topology_key(tm, FEET, pairs)
    assert key == _build.topology_key(tm, FEET) + pairs
    assert (2, tcf.OBSTACLE) in pairs[0] and (2, 5) in pairs[0]
    macros = _build._macros(key)
    assert "-DGRID_FF_KC=10" in macros and "-DGRID_FF_L=1" in macros
    assert "-DGRID_FF_LA=G(2)" in macros and "-DGRID_FF_LB=G(-1)" in macros
    assert _build._digest(key) != _build._digest(_build.topology_key(tm,
                                                                     FEET))
    moved = _collision("rich", "port")
    assert len(tcf.collision_values(tcf.collision_static(moved))) == \
        14 * moved.n_contacts
    assert all(isinstance(v, float) for v in tcf.collision_values(cs))


def test_cpu_tensors_launch_nothing():
    """Collision and loop steps on CPU tensors run the plain version."""
    _launch.reset_launches()
    test_loop_rollout_equals_its_steps()
    _, tm = _models("hyq")
    s = [torch.from_numpy(x) for x in _hyq_states(2, 3)]
    tct.fb_step_ground_batched(tm, tuple(s[:5]), s[5], DT, FEET, FOFF,
                               collision=_collision("rich", "port"))
    assert not any(_launch.LAUNCHES.values())
