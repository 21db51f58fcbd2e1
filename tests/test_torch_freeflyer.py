"""The port's free-flyer slice against the JAX package.

The free-flyer model and ``ff_from_jax_arrays``, the quaternion helpers,
the floating-base ABA and the mass-matrix FD (their plain versions, their
wrappers on CPU tensors and ``fb_forward_dynamics_batched``) on free-flyer
HyQ and the 3-link chain, float64. The JAX references are its
``fb_forward_dynamics_batched`` with ``impl="vmap"`` (ABA) and
``impl="chol"``, which off the TPU run the kernel bodies as plain XLA
(``_xla_fallback``), each computed once a robot, and one interpret-mode
``fb_aba_fused`` on the chain. Also: ABA against the Cholesky FD, an
armature case, the batch shapes, the float64 default, the ``impl`` errors
and that a CPU run never reaches a kernel launch.

Tolerance 1e-10·max(1, |ref|) per element: the same sums in the same order.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu.models import zoo as jzoo
from gridcodegenerator_tpu.ops import freeflyer as jff
from gridcodegenerator_tpu.ops.kernels import contact_fused as jcf
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.models.robot import MODEL_FIELDS
from gridcodegenerator_tpu_torch.ops import freeflyer as tff
from gridcodegenerator_tpu_torch.ops.kernels import _launch
from gridcodegenerator_tpu_torch.ops.kernels import contact_fused as tcf

torch.set_num_threads(1)

ROBOTS = {"hyq": lambda z: z.hyq(damping=0.2),
          "chain3": lambda z: z.serial_chain(3, damping=0.1)}
# the joints' mean posture (HyQ's stance, tests/test_contact_fused.py)
POSTURE = {"hyq": [-0.1, 0.7, -1.2], "chain3": [0.0]}
BATCH = (2, 3)
ARMATURE = 0.05
IMPLS = {"aba": ("vmap", "auto", tcf.fb_aba_plain, tcf.fb_aba_fused),
         "chol": ("chol", "chol", tcf.fb_fd_plain, tcf.fb_fd_fused)}


def assert_close(got, ref, tol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


def _desc(parse, name, armature):
    desc = parse(ROBOTS[name](jzoo if parse is g.parse_urdf else tzoo))
    if armature:
        desc = dataclasses.replace(desc, armature=np.full(desc.n, armature))
    return desc


@functools.cache
def _case(name, armature=0.0):
    """(JAX model, port model, batch-first numpy states (2, 3, ·)): a unit
    quaternion, pos about z = 0.5, q about the posture ± 0.1, vb ± 0.6,
    q̇ ± 0.5, τ ± 10."""
    jm = jff.free_flyer_model(_desc(g.parse_urdf, name, armature),
                              dtype=jnp.float64)
    tm = tff.free_flyer_model(_desc(gt.parse_urdf, name, armature),
                              device="cpu")
    n, B = jm.n, int(np.prod(BATCH))
    rng = np.random.default_rng(5)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.5]
    q = (np.tile(POSTURE[name], (B, n // len(POSTURE[name])))
         + rng.uniform(-0.1, 0.1, (B, n)))
    vb = rng.uniform(-0.6, 0.6, (B, 6))
    qd = rng.uniform(-0.5, 0.5, (B, n))
    tau = rng.uniform(-10, 10, (B, n))
    return jm, tm, [x.reshape(BATCH + x.shape[1:])
                    for x in (quat, pos, q, vb, qd, tau)]


def _fb_states(s):
    """(quat, q, vb, qd, tau) of the six."""
    return [s[0], *s[2:]]


@functools.cache
def _jax_ref(name, impl, armature=0.0):
    """JAX fb_forward_dynamics_batched on the (2, 3) states: (v̇b, q̈)."""
    jm, _, s = _case(name, armature)
    out = jff.fb_forward_dynamics_batched(
        jm, *(jnp.asarray(x) for x in _fb_states(s)), impl=IMPLS[impl][0])
    return tuple(np.asarray(o) for o in out)


def _cols(x):
    return torch.from_numpy(x.reshape(-1, x.shape[-1]).T.copy())


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("name", list(ROBOTS))
def test_ff_model_matches_jax(name):
    """The arm's constants and I_base equal the JAX model's; its leaves
    carry across through ff_from_jax_arrays."""
    jm, tm, _ = _case(name)
    arrays = {f: np.asarray(getattr(jm.arm, f)) for f in MODEL_FIELDS}
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(tm.arm, f).numpy(), arrays[f],
                                      err_msg=f)
    np.testing.assert_array_equal(tm.I_base.numpy(), np.asarray(jm.I_base))
    conv = tff.ff_from_jax_arrays(arrays, np.asarray(jm.I_base),
                                  jm.arm.topology.parents,
                                  jm.arm.joint_types, jm.arm.name,
                                  device="cpu")
    assert conv.dtype == torch.float64 and conv.n == jm.n
    assert conv.topology.parents == tm.topology.parents
    for f in MODEL_FIELDS:
        assert torch.equal(getattr(conv.arm, f), getattr(tm.arm, f)), f
    assert torch.equal(conv.I_base, tm.I_base)


def test_ff_model_defaults_and_packed_layout():
    """float64 unless asked (the JAX default), the card unless the CPU is
    named, no accurate_trig; the packed buffer is the arm's then I_base."""
    desc = gt.parse_urdf(tzoo.serial_chain(3, damping=0.1))
    m = tff.free_flyer_model(desc, device="cpu")
    assert m.dtype == torch.float64 and m.I_base.dtype == torch.float64
    assert tff.free_flyer_model(desc, dtype=torch.float32,
                                device="cpu").dtype == torch.float32
    if torch.cuda.is_available():
        assert tff.free_flyer_model(desc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tff.free_flyer_model(desc)
    with pytest.raises(NotImplementedError, match="accurate_trig"):
        tff.free_flyer_model(desc, device="cpu", accurate_trig=True)
    assert m.packed.shape == (152 * m.n + 36,)
    assert torch.equal(m.packed[:152 * m.n], m.arm.packed)
    assert torch.equal(m.packed[152 * m.n:], m.I_base.reshape(-1))
    m32 = m.to(dtype=torch.float32)
    assert m32.packed.dtype == torch.float32 and m.dtype == torch.float64


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 4))
    a /= np.linalg.norm(a)
    w = rng.uniform(-1, 1, 3)
    t = lambda x: torch.from_numpy(np.asarray(x))
    assert_close(tff.quat_to_rot(t(a)), jff.quat_to_rot(jnp.asarray(a)),
                 1e-15)
    assert_close(tff.quat_mul(t(a), t(b)),
                 jff.quat_mul(jnp.asarray(a), jnp.asarray(b)), 1e-15)
    assert_close(tff.quat_exp_body(t(w)), jff.quat_exp_body(jnp.asarray(w)),
                 1e-15)
    R = np.asarray(jff.quat_to_rot(jnp.asarray(a)))
    assert_close(tff.rot_to_quat(t(R)), jff.rot_to_quat(jnp.asarray(R)),
                 1e-14)
    # batched: one call over a (2, 4) stack equals two single calls
    ab = t(np.stack([a, b]))
    assert_close(tff.quat_to_rot(ab)[1], jff.quat_to_rot(jnp.asarray(b)),
                 1e-15)


# ------------------------------------------------- the bodies vs the JAX
@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", list(ROBOTS))
def test_fb_plain_and_wrapper_match_jax(name, impl):
    """The plain version and the wrapper (which on CPU tensors runs it),
    batch last, against the JAX batched entry."""
    _, tm, s = _case(name)
    ref = _jax_ref(name, impl)
    B = int(np.prod(BATCH))
    cols = [_cols(x) for x in _fb_states(s)]
    for fn in IMPLS[impl][2:]:
        out = fn(tm, *cols)
        for got, r in zip(out, ref):
            assert_close(got, r.reshape(B, -1).T)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("batch", [(), (6,), (2, 3)])
def test_fb_batched_shapes_match_jax(batch, impl):
    """fb_forward_dynamics_batched on HyQ over a single state, a (6,) and a
    (2, 3) batch: batch-first outputs equal to the JAX entry's."""
    _, tm, s = _case("hyq")
    ref = _jax_ref("hyq", impl)
    shape = batch if batch != () else (1,)
    states = [torch.from_numpy(x.reshape(-1, x.shape[-1])[:int(np.prod(
        shape))].reshape(batch + x.shape[-1:]).copy())
        for x in _fb_states(s)]
    out = tff.fb_forward_dynamics_batched(tm, *states, impl=IMPLS[impl][1])
    for got, r, w in zip(out, ref, (6, tm.n)):
        assert tuple(got.shape) == batch + (w,)
        assert_close(got, r.reshape(-1, w)[:int(np.prod(shape))].reshape(
            batch + (w,)))


@pytest.mark.parametrize("impl", list(IMPLS))
def test_fb_armature_matches_jax(impl):
    _, tm, s = _case("chain3", ARMATURE)
    out = tff.fb_forward_dynamics_batched(
        tm, *(torch.from_numpy(x) for x in _fb_states(s)),
        impl=IMPLS[impl][1])
    for got, r in zip(out, _jax_ref("chain3", impl, ARMATURE)):
        assert_close(got, r)


def test_fb_aba_matches_interpret_kernel():
    """The wrapper on CPU tensors against the JAX Pallas kernel in
    interpret mode, on the chain at B = 3."""
    jm, tm, s = _case("chain3")
    cols = [x.reshape(-1, x.shape[-1])[:3].T.copy() for x in _fb_states(s)]
    ref = jcf.fb_aba_fused(jm, *(jnp.asarray(c) for c in cols),
                           interpret=True)
    out = tcf.fb_aba_fused(tm, *(torch.from_numpy(c) for c in cols))
    for got, r in zip(out, ref):
        assert_close(got, r)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_fb_aba_matches_cholesky(name):
    """Two algorithms for the same accelerations: O(n) ABA and the (6+n)²
    mass-matrix Cholesky, round-off apart."""
    _, tm, s = _case(name)
    states = [torch.from_numpy(x) for x in _fb_states(s)]
    aba = tff.fb_forward_dynamics_batched(tm, *states)
    chol = tff.fb_forward_dynamics_batched(tm, *states, impl="chol")
    for a, c in zip(aba, chol):
        assert_close(a, c.numpy(), 1e-9)


# ------------------------------------------------ routing and fallback
def test_fb_impl_errors():
    _, tm, s = _case("chain3")
    states = [torch.from_numpy(x) for x in _fb_states(s)]
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tff.fb_forward_dynamics_batched(tm, *states, impl="cuda")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, 'The per-state tier"):
        tff.fb_forward_dynamics_batched(tm, *states, impl="vmap")
    with pytest.raises(ValueError, match="impl must be one of"):
        tff.fb_forward_dynamics_batched(tm, *states, impl="pallas")


def test_fb_cpu_never_launches(monkeypatch):
    """On CPU tensors both routes run their plain versions: the launch
    function is never reached and nothing is counted."""
    _, tm, s = _case("chain3")
    states = [torch.from_numpy(x) for x in _fb_states(s)]
    before = dict(_launch.LAUNCHES)

    def no_launch(*a, **kw):
        raise AssertionError("a CPU tensor reached a kernel launch")
    monkeypatch.setattr(tcf, "launch", no_launch)
    for impl in ("auto", "chol"):
        tff.fb_forward_dynamics_batched(tm, *states, impl=impl)
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize("fn", [tcf.fb_aba_fused, tcf.fb_fd_fused])
def test_fb_no_fallback_off_cpu(fn):
    """Tensors on neither the CPU nor a CUDA device raise: a wrapper runs
    its plain version on CPU tensors only."""
    _, tm, _ = _case("chain3")
    meta = [torch.empty((d, 3), dtype=torch.float64, device="meta")
            for d in (4, tm.n, 6, tm.n, tm.n)]
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fn(tm, *meta)
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize("case", ["quat", "vb", "q", "batch"])
def test_fb_shape_errors(case):
    _, tm, s = _case("chain3")
    quat, q, vb, qd, tau = (torch.from_numpy(x) for x in _fb_states(s))
    args = {"quat": (q, q, vb, qd, tau), "vb": (quat, q, q, qd, tau),
            "q": (quat, vb, vb, qd, tau), "batch": (quat, q[:1], vb, qd,
                                                    tau)}[case]
    match = {"quat": "quat must have trailing dimension 4",
             "vb": "vb must have trailing dimension 6",
             "q": "q must have trailing dimension 3",
             "batch": "batch shapes disagree"}[case]
    with pytest.raises(ValueError, match=match):
        tff.fb_forward_dynamics_batched(tm, *args)
