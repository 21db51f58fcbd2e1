"""The port's MJCF front end and collision data against the JAX package's.

``models/mjcf.py`` is a copy: on the zoo's ant fixtures (with and without
sensors) and on every MJCF document of ``tests/test_mjcf.py``, each
accessor — ``parse_mjcf``, ``mjcf_sites``, ``mjcf_bodies``,
``mjcf_actuators``, ``mjcf_tendons``, ``mjcf_loops``, ``mjcf_welds``,
``mjcf_sensors`` and the geometry of ``mjcf_collision_model`` — must give
the JAX package's result field by field, exactly (or raise its error with
its message). ``ops/collision.py``'s geom builders, the ground-contact list
and ``auto_pairs`` likewise. And the inherited range rule of fixed tendons
(ROADMAP Queue 3, 'Inherited through the shared MJCF front end') is pinned:
any present ``range``, the parser's own ``"0 0"`` included, counts as an
active limit, so a ``<default>`` margin raises in both packages.
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu.models.mjcf as jmj
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu.ops import collision as jcol
from gridcodegenerator_tpu.ops.kernels import contact_fused as jcf
from gridcodegenerator_tpu_torch.models import mjcf as tmj
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import collision as tcol

torch.set_num_threads(1)

FIXTURES = {
    "ant": lambda z: z.ant_mjcf(),
    "ant_sensors": lambda z: z.ant_mjcf(sensors=True),
    "ball_ant": lambda z: z.ball_ant_mjcf(),
    "ball_ant_sensors": lambda z: z.ball_ant_mjcf(sensors=True),
}
# the MJCF documents written out in tests/test_mjcf.py
_DOCS = [n.value for n in ast.walk(ast.parse(
    (Path(__file__).parent / "test_mjcf.py").read_text()))
    if isinstance(n, ast.Constant) and isinstance(n.value, str)
    and "<mujoco" in n.value and "</mujoco>" in n.value]
DOCUMENTS = {**{k: f(jzoo) for k, f in FIXTURES.items()},
             **{f"test_mjcf_{i}": d for i, d in enumerate(_DOCS)}}
ACCESSORS = ("parse_mjcf", "mjcf_sites", "mjcf_bodies", "mjcf_actuators",
             "mjcf_tendons", "mjcf_loops", "mjcf_welds", "mjcf_sensors")


# fields a port-side named tuple has beyond its JAX counterpart's
PORT_FIELDS = {"Geoms": ("ground",), "CollisionModel": ("static",)}


def _same(a, b, where="") -> None:
    """Assert that a JAX-side value and a port-side one are equal: arrays
    and tensors exactly (NaN equal to NaN), containers element by
    element, dataclasses and named tuples field by field (a geom set's
    ground-contact list against the JAX package's builder)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif hasattr(a, "_fields"):
        assert b._fields == a._fields + PORT_FIELDS.get(type(b).__name__, ()), \
            where
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f"{where}.{f}")
        if type(b).__name__ == "Geoms":
            # the ground-contact list the port keeps on a geom set
            _same(jcf.ground_geoms_static(a), b.ground, f"{where}.ground")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif hasattr(a, "parents") and hasattr(a, "ancestors"):
        assert tuple(a.parents) == tuple(b.parents), where
    elif a is None or isinstance(a, (str, bool, int, float)):
        assert a == b or (a != a and b != b), (where, a, b)
    else:
        x = np.asarray(a)
        y = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
             else np.asarray(b))
        assert x.shape == y.shape, (where, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), where


def _both(fn_name, doc, **kw):
    """(JAX result, port result) of an accessor, or the two exceptions'
    types and messages."""
    out = []
    for mod in (jmj, tmj):
        try:
            out.append(getattr(mod, fn_name)(doc, **kw))
        except Exception as e:       # noqa: BLE001 — compared below
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_accessors_match_jax(name):
    doc = DOCUMENTS[name]
    for fn_name in ACCESSORS:
        a, b = _both(fn_name, doc)
        _same(a, b, f"{name}:{fn_name}")


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_collision_model_geometry_matches_jax(name):
    """mjcf_collision_model: the description and the collision set (geoms,
    pairs, obstacles, obstacle pairs) equal the JAX package's, as float64
    tensors on the CPU."""
    doc = DOCUMENTS[name]
    for base in ("link", "obstacle"):
        a, b = [], []
        for mod, out, kw in ((jmj, a, dict(dtype=jnp.float64)),
                             (tmj, b, dict(dtype=torch.float64,
                                           device="cpu"))):
            try:
                out.append(mod.mjcf_collision_model(doc, base_geoms=base,
                                                    **kw))
            except Exception as e:   # noqa: BLE001 — compared below
                out.append((type(e).__name__, str(e)))
        _same(a[0], b[0], f"{name}:{base}")


def test_zoo_documents_equal():
    for name, f in FIXTURES.items():
        assert f(tzoo) == f(jzoo), name


def test_collision_model_defaults_to_the_card():
    """Like every port builder, the collision model is built on the card
    unless the caller names another device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmj.mjcf_collision_model(tzoo.ball_ant_mjcf())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcol.make_geoms([0], a=[[0, 0, 0]])


def _tendon_doc(tendon_attrs, default_attrs):
    return f"""
<mujoco model="t"><compiler angle="radian"/>
  <default><tendon {default_attrs}/></default>
  <worldbody><body name="a"><joint name="j0" axis="0 0 1"/>
    <geom type="sphere" size="0.1"/>
    <body name="b" pos="0.2 0 0"><joint name="j1" axis="0 0 1"/>
      <geom type="sphere" size="0.1"/></body></body></worldbody>
  <tendon><fixed name="t0" {tendon_attrs}>
    <joint joint="j0" coef="1"/><joint joint="j1" coef="-1"/>
  </fixed></tendon>
</mujoco>"""


@pytest.mark.parametrize("range_attr", ['range="0 0"', 'range="-1 1"',
                                        'limited="true" range="0 0"'])
def test_tendon_range_counts_as_active(range_attr):
    """ROADMAP Queue 3, 'Inherited through the shared MJCF front end'
    (mjcf.py:1057): any present range — the parser's own "0 0" included —
    makes a <default> class's nonzero margin an unsupported attribute: both
    packages raise NotImplementedError with the same message. Without a
    range the margin is ignored in both."""
    doc = _tendon_doc(range_attr, 'margin="0.05"')
    msgs = []
    for mod in (jmj, tmj):
        with pytest.raises(NotImplementedError) as e:
            mod.mjcf_tendons(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "margin" in msgs[0]
    free = _tendon_doc("", 'margin="0.05"')
    _same(jmj.mjcf_tendons(free), tmj.mjcf_tendons(free), "no range")


GEOM_SETS = {
    "spheres": ((0, 1), [[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]], None,
                [0.1, 0.05]),
    "capsules": ((-1, 2, 2), [[-0.3, 0, 0], [0, 0, 0], [0.1, 0, 0]],
                 [[0.3, 0, 0], [0.2, 0, 0], [0.1, 0, 0]], [0.2, 0.03, 0.03]),
}


@pytest.mark.parametrize("name", list(GEOM_SETS))
def test_geoms_and_ground_contacts_match_jax(name):
    """make_geoms, _ground_contact_list (one contact a sphere, two a
    capsule), n_ground_contacts and auto_pairs on HyQ's tree."""
    links, a, b, r = GEOM_SETS[name]
    jg = jcol.make_geoms(links, a, b, r, dtype=jnp.float64)
    tg = tcol.make_geoms(links, a, b, r, dtype=torch.float64, device="cpu")
    _same(jg, tg, name)
    assert tcol._ground_contact_list(tg) == jcol._ground_contact_list(jg)
    assert tcol.n_ground_contacts(tg) == jcol.n_ground_contacts(jg)
    topo = tmj.parse_mjcf(tzoo.ant_mjcf()).topology
    assert tcol.auto_pairs(topo, tg) == jcol.auto_pairs(topo, jg)
    ob = ([[0.0, 0.0, -1.0]], [[1.0, 0.0, -1.0]], 0.3)
    jcm = jcol.make_collision_model(
        jg, topo, obstacles=jcol.make_obstacles(*ob, dtype=jnp.float64))
    tcm = tcol.make_collision_model(
        tg, topo, obstacles=tcol.make_obstacles(*ob, dtype=torch.float64,
                                                device="cpu"))
    _same(jcm, tcm, name)
    assert tcm.n_contacts == jcm.n_contacts


def test_check_geoms_messages_match_jax():
    tg = tcol.make_geoms((5,), [[0.0, 0.0, 0.0]], dtype=torch.float64,
                         device="cpu")
    jg = jcol.make_geoms((5,), [[0.0, 0.0, 0.0]], dtype=jnp.float64)
    for allow in (True, False):
        msgs = []
        for mod, gs in ((jcol, jg), (tcol, tg)):
            with pytest.raises(ValueError) as e:
                mod._check_geoms(3, mod.make_collision_model(gs),
                                 allow_base=allow)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
