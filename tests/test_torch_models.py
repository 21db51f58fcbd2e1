"""The port's NumPy front end and torch RobotModel against the JAX package:
URDF fixtures, the parser and the model constants must agree exactly."""

import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup
from gridcodegenerator_tpu.models import urdf as jurdf
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu_torch.models import urdf as turdf
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.models.robot import MODEL_FIELDS
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops.kernels import _build

torch.set_num_threads(1)

SLICE_ROBOTS = ["iiwa14", "chain5p", "barm", "dpend"]

FIXTURES = {
    "iiwa14": lambda z: z.iiwa14(damping=0.1),
    "panda": lambda z: z.panda(damping=0.15),
    "hyq": lambda z: z.hyq(damping=0.2),
    "branched_arm": lambda z: z.branched_arm(damping=0.12),
    "atlas": lambda z: z.atlas(damping=0.05),
    "serial_chain": lambda z: z.serial_chain(5, damping=0.1,
                                             prismatic_every=2),
    "random_tree": lambda z: z.random_tree(12, seed=3),
    "double_pendulum": lambda z: z.double_pendulum(),
    "four_bar": lambda z: z.four_bar(damping=0.05),
    "ball_arm": lambda z: z.ball_arm(damping=0.1),
    "free_iiwa14": lambda z: z.with_free_joint(z.iiwa14(damping=0.1)),
    "free_atlas": lambda z: z.with_free_joint(z.atlas()),
    "expand_spherical": lambda z: z.expand_spherical(z.ball_arm(damping=0.1)),
    "floating_base_hyq": lambda z: z.with_floating_base(z.hyq(damping=0.2)),
    "floating_base_atlas": lambda z: z.with_floating_base(z.atlas()),
}


@pytest.mark.parametrize("urdf_fn", list(FIXTURES))
def test_zoo_urdf_identical(urdf_fn):
    assert FIXTURES[urdf_fn](tzoo) == FIXTURES[urdf_fn](jzoo)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_parse_urdf_identical(name):
    ref = g.parse_urdf(ROBOTS[name])
    got = gt.parse_urdf(ROBOTS[name])
    assert got.name == ref.name
    assert got.joint_types == ref.joint_types
    assert got.topology.parents == ref.topology.parents
    assert got.topology.joint_names == ref.topology.joint_names
    assert got.topology.link_names == ref.topology.link_names
    assert got.topology.ancestors == ref.topology.ancestors
    assert got.topology.subtrees == ref.topology.subtrees
    assert got.mimic == ref.mimic
    for field in ("origin_xyz", "origin_rpy", "axis", "damping", "inertia",
                  "base_inertia", "q_lower", "q_upper", "effort", "velocity",
                  "armature", "frictionloss"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field), err_msg=field)


@pytest.mark.parametrize("name", SLICE_ROBOTS)
def test_robot_model_constants_identical(name):
    _, _, jm = get_setup(name)  # JAX model, float64
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    assert tm.n == jm.n
    assert tm.topology.parents == jm.topology.parents
    assert tm.joint_types == jm.joint_types
    assert tm.name == jm.name
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    np.testing.assert_array_equal(tm.prismatic.numpy(),
                                  np.asarray(jm.prismatic))


@pytest.mark.parametrize("name", SLICE_ROBOTS + ["atlas"])
def test_from_jax_arrays_matches_load_robot(name):
    """The JAX model's leaves carry across: on Atlas (a 28-joint forest)
    as on the small robots."""
    _, _, jm = get_setup(name)
    arrays = {f: np.asarray(getattr(jm, f)) for f in MODEL_FIELDS}
    conv = gt.from_jax_arrays(arrays, jm.topology.parents, jm.joint_types,
                              jm.name, device="cpu")
    own = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    assert conv.dtype == torch.float64
    assert conv.topology.parents == own.topology.parents
    assert conv.joint_types == own.joint_types
    for f in MODEL_FIELDS + ("prismatic",):
        assert torch.equal(getattr(conv, f), getattr(own, f)), f


def test_model_to_and_packed_layout():
    m = gt.load_robot(ROBOTS["barm"], dtype=torch.float64, device="cpu")
    m32 = m.to(dtype=torch.float32)
    assert m32.dtype == torch.float32 and m.dtype == torch.float64
    assert m32.prismatic.dtype == torch.bool
    n = m.n
    assert m.packed.shape == (152 * n,)
    # Xb, Xs, Xc, S, inertia, damping, armature — the csrc/rbd.cuh layout
    offsets = {"Xb": 0, "Xs": 36 * n, "Xc": 72 * n, "S": 108 * n,
               "inertia": 114 * n, "damping": 150 * n, "armature": 151 * n}
    for f, off in offsets.items():
        t = getattr(m, f).reshape(-1)
        assert torch.equal(m.packed[off:off + t.numel()], t), f


@pytest.mark.parametrize("build", ["load_robot", "from_description",
                                   "from_jax_arrays"])
def test_default_device_is_the_card(build):
    """Models are built on the card unless the caller names the CPU: on a
    host without CUDA the default raises instead of returning a CPU
    model (and on a host with one it builds there)."""
    urdf = ROBOTS["iiwa14"]
    _, _, jm = get_setup("iiwa14")
    calls = {
        "load_robot": lambda **kw: gt.load_robot(urdf, **kw),
        "from_description": lambda **kw: gt.robot_model_from_description(
            gt.parse_urdf(urdf), **kw),
        "from_jax_arrays": lambda **kw: gt.from_jax_arrays(
            {f: np.asarray(getattr(jm, f)) for f in MODEL_FIELDS},
            jm.topology.parents, jm.joint_types, jm.name, **kw),
    }
    if torch.cuda.is_available():
        assert calls[build]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            calls[build]()
    assert calls[build](device="cpu").device.type == "cpu"


def test_accurate_trig_not_ported():
    with pytest.raises(NotImplementedError,
                       match="accurate_trig.*ROADMAP Queue 1, 'The per-state "
                             "tier and differentiability'"):
        gt.robot_model_from_description(gt.parse_urdf(ROBOTS["iiwa14"]),
                                        accurate_trig=True)


def test_multidof_description_error_matches_jax():
    """A description with ball or free joints is refused with the JAX
    package's message, which names the multi-dof constructor."""
    urdf = lambda z: z.with_free_joint(z.iiwa14())
    with pytest.raises(ValueError) as ref:
        g.robot_model_from_description(g.parse_urdf(urdf(jzoo)))
    with pytest.raises(ValueError) as got:
        gt.robot_model_from_description(gt.parse_urdf(urdf(tzoo)),
                                        device="cpu")
    assert str(got.value) == str(ref.value)
    assert "multidof_model_from_description" in str(got.value)


@pytest.mark.parametrize("name", ["free_hyq", "free_chain3"])
def test_demote_floating_root_identical(name):
    """The MJCF-style free root demoted to a free-flyer arm: every field
    equal to the JAX package's demotion."""
    urdf = {"free_hyq": lambda z: z.with_free_joint(z.hyq(damping=0.2)),
            "free_chain3": lambda z: z.with_free_joint(
                z.serial_chain(3, damping=0.1))}[name]
    ref = jurdf.demote_floating_root(g.parse_urdf(urdf(jzoo)))
    got = turdf.demote_floating_root(gt.parse_urdf(urdf(tzoo)))
    assert got.name == ref.name and got.joint_types == ref.joint_types
    assert got.topology.parents == ref.topology.parents
    assert got.topology.joint_names == ref.topology.joint_names
    assert got.topology.link_names == ref.topology.link_names
    assert got.mimic == ref.mimic
    for field in ("origin_xyz", "origin_rpy", "axis", "damping", "inertia",
                  "base_inertia", "q_lower", "q_upper", "effort", "velocity",
                  "armature", "frictionloss"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field), err_msg=field)
    with pytest.raises(ValueError, match="not a floating root") as e:
        turdf.demote_floating_root(gt.parse_urdf(tzoo.hyq()))
    with pytest.raises(ValueError) as je:
        jurdf.demote_floating_root(g.parse_urdf(jzoo.hyq()))
    assert str(e.value) == str(je.value)


def test_ff_build_keys_carry_the_links():
    """A free flyer's libraries: the arm's key tagged "ff", one without
    contacts (ABA and the mass-matrix FD) and one per set of contact links
    (the stance kernel), each with its own macros and digest."""
    m = tff.free_flyer_model(gt.parse_urdf(tzoo.hyq()), device="cpu")
    arm_key = _build.topology_key(m.arm)
    keys = {links: _build.topology_key(m, links)
            for links in ((), (2, 5, 8, 11), (2, 5))}
    for links, key in keys.items():
        assert key == ("ff",) + arm_key + (links,)
        assert _build._units(key) == ("ff.cu",)
    assert _build.topology_key(m) == keys[()]
    macros = {links: _build._macros(key) for links, key in keys.items()}
    assert "-DGRID_FF_K=0" in macros[()]
    assert not any(x.startswith("-DGRID_FF_LINKS") for x in macros[()])
    assert "-DGRID_FF_K=4" in macros[(2, 5, 8, 11)]
    assert "-DGRID_FF_LINKS=G(2)G(5)G(8)G(11)" in macros[(2, 5, 8, 11)]
    digests = {_build._digest(k) for k in keys.values()}
    assert len(digests) == 3 and _build._digest(arm_key) not in digests
