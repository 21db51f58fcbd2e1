"""The port's multi-dof slice (ball and free joints) against the JAX package.

The model constants, ``md_from_jax_arrays``, ``md_tangent_apply``, the four
plain bodies and their wrappers on CPU tensors, and the four batched entry
points, on the JAX package's three multi-dof test robots (the ball arm,
free-joint iiwa-14 and a mixed revolute/prismatic chain), float64. The JAX
references are the batched entry points, which off the TPU run the kernel
bodies with ``force_xla=True`` — no interpret-mode Pallas; each is computed
once a robot. Also: a nonzero armature, free HyQ's ∇FD against central
differences of the port's own ABA on the manifold, routing, no fallback,
the formerly unported options (``impl="crba"``, the gradients past
``MAX_MD_GRAD_NV``) and the shape errors.

Tolerance 1e-10·max(1, |ref|) per element against JAX: the same sums in
the same order.
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
from gridcodegenerator_tpu.ops import multidof as jmd
from gridcodegenerator_tpu_torch.models import zoo as tzoo
from gridcodegenerator_tpu_torch.ops import multidof as tmd
from gridcodegenerator_tpu_torch.ops.kernels import _build, _launch
from gridcodegenerator_tpu_torch.ops.kernels import multidof_fused as tmf

torch.set_num_threads(1)

ROBOTS = {
    "ball": lambda z: z.ball_arm(damping=0.1),
    "free": lambda z: z.with_free_joint(z.iiwa14(damping=0.1)),
    "mixed": lambda z: z.serial_chain(5, damping=0.1, prismatic_every=2),
}
BATCH = (2, 3)
ARMATURE = 0.05


def assert_close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= 1e-10 * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


def _desc(parse, name, armature):
    desc = parse(ROBOTS[name](jzoo if parse is g.parse_urdf else tzoo))
    if armature:
        desc = dataclasses.replace(desc, armature=np.full(desc.n, armature))
    return desc


@functools.cache
def _case(name, armature=0.0):
    """(JAX model, port model, batch-first numpy states (2, 3, ·)): the
    JAX fixture's states — neutral_q ⊕ a tangent in [−0.6, 0.6] (by the
    JAX md_tangent_apply), q̇ ∈ [−0.8, 0.8], u ∈ [−5, 5]."""
    jm = jmd.multidof_model_from_description(
        _desc(g.parse_urdf, name, armature), dtype=jnp.float64)
    tm = gt.multidof_model_from_description(
        _desc(gt.parse_urdf, name, armature), dtype=torch.float64,
        device="cpu")
    B = int(np.prod(BATCH))
    rng = np.random.default_rng(29)
    dq = rng.uniform(-0.6, 0.6, (B, jm.nv))
    q0 = jmd.neutral_q(jm)
    q = np.stack([np.asarray(jmd.md_tangent_apply(jm, q0, jnp.asarray(d)))
                  for d in dq])
    qd = rng.uniform(-0.8, 0.8, (B, jm.nv))
    u = rng.uniform(-5, 5, (B, jm.nv))
    return jm, tm, [x.reshape(BATCH + x.shape[1:]) for x in (q, qd, u)]


# family → (JAX batched entry, port batched entry, port wrapper, port plain
# version, number of (q, q̇, u) inputs; u stands for q̈ in ID and ∂ID)
FAMILIES = {
    "id": (jmd.md_inverse_dynamics_batched, gt.md_inverse_dynamics_batched,
           tmf.md_id_fused, tmf.md_id_plain, 3),
    "bias": (jmd.md_inverse_dynamics_batched,
             gt.md_inverse_dynamics_batched, tmf.md_id_fused,
             tmf.md_id_plain, 2),
    "aba": (jmd.md_forward_dynamics_batched, gt.md_forward_dynamics_batched,
            tmf.md_aba_fused, tmf.md_aba_plain, 3),
    "id_grad": (jmd.md_id_grad_batched, gt.md_id_grad_batched,
                tmf.md_id_grad_fused, tmf.md_id_grad_plain, 3),
    "id_grad_noqdd": (jmd.md_id_grad_batched, gt.md_id_grad_batched,
                      tmf.md_id_grad_fused, tmf.md_id_grad_plain, 2),
    "fd_grad": (jmd.md_forward_dynamics_gradient_batched,
                gt.md_forward_dynamics_gradient_batched, tmf.md_fd_grad_fused,
                tmf.md_fd_grad_plain, 3),
}


@functools.cache
def _jax_ref(name, fam, armature=0.0):
    """The JAX batched entry on the (2, 3) states, as numpy (a tuple)."""
    jm, _, s = _case(name, armature)
    k = FAMILIES[fam][4]
    out = FAMILIES[fam][0](jm, *(jnp.asarray(x) for x in s[:k]))
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                         else (out,)))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("name", list(ROBOTS) + ["free_hyq", "free_atlas"])
def test_md_model_identical(name):
    """Constants, slices and layout equal the JAX model's; the JAX model's
    leaves carry across through md_from_jax_arrays."""
    urdf = {"free_hyq": lambda z: z.with_free_joint(z.hyq()),
            "free_atlas": lambda z: z.with_free_joint(z.atlas())}.get(
                name, ROBOTS.get(name))
    jm = jmd.multidof_model_from_description(g.parse_urdf(urdf(jzoo)),
                                             dtype=jnp.float64)
    tm = gt.multidof_model_from_description(gt.parse_urdf(urdf(tzoo)),
                                            dtype=torch.float64,
                                            device="cpu")
    assert tm.n == jm.n_joints and (tm.nq, tm.nv) == (jm.nq, jm.nv)
    assert tm.joint_types == jm.joint_types and tm.name == jm.name
    assert tm.q_slices == jm.q_slices and tm.v_slices == jm.v_slices
    assert tm.topology.parents == jm.topology.parents
    arrays = {f: np.asarray(getattr(jm, f)) for f in tmd.MD_FIELDS}
    for f in tmd.MD_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), arrays[f],
                                      err_msg=f)
    conv = gt.md_from_jax_arrays(arrays, jm.topology.parents, jm.joint_types,
                                 jm.q_slices, jm.v_slices, jm.name,
                                 device="cpu")
    assert conv.dtype == torch.float64 and conv.nv == tm.nv
    assert conv.q_slices == tm.q_slices and conv.v_slices == tm.v_slices
    for f in tmd.MD_FIELDS:
        assert torch.equal(getattr(conv, f), getattr(tm, f)), f
    np.testing.assert_array_equal(gt.neutral_q(tm).numpy(),
                                  np.asarray(jmd.neutral_q(jm)))


def test_md_model_default_device_and_packed_layout():
    urdf = tzoo.ball_arm()
    if torch.cuda.is_available():
        assert gt.multidof_model_from_description(
            gt.parse_urdf(urdf)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gt.multidof_model_from_description(gt.parse_urdf(urdf))
    m = gt.multidof_model_from_description(gt.parse_urdf(urdf),
                                           dtype=torch.float64, device="cpu")
    n, nv = m.n, m.nv
    K, KK = (torch.from_numpy(x) for x in m.rot_coeffs)
    # XT, inertia, K, K·K, S's first column, damping, armature — md.cuh
    parts = {0: m.XT, 36 * n: m.inertia, 72 * n: K, 81 * n: KK,
             90 * n: m.S[:, :, 0], 96 * n: m.damping, 96 * n + nv: m.armature}
    assert m.packed.shape == (96 * n + 2 * nv,)
    for off, t in parts.items():
        t = t.reshape(-1)
        assert torch.equal(m.packed[off:off + t.numel()], t), off
    assert m.to(dtype=torch.float32).packed.dtype == torch.float32


def test_md_default_dtype_is_float64():
    """The JAX package's default (float64): float64 states run on a model
    built without a dtype, and float32 is asked for by name."""
    desc = gt.parse_urdf(tzoo.ball_arm(damping=0.1))
    m = gt.multidof_model_from_description(desc, device="cpu")
    assert m.dtype == torch.float64 and m.packed.dtype == torch.float64
    assert gt.multidof_model_from_description(
        desc, dtype=torch.float32, device="cpu").dtype == torch.float32
    _, tm, s = _case("ball")
    q, qd, u = (torch.from_numpy(x) for x in s)
    assert_close(gt.md_forward_dynamics_batched(m, q, qd, u),
                 _jax_ref("ball", "aba")[0])


@pytest.mark.parametrize("name", list(ROBOTS))
def test_md_tangent_apply_matches_jax(name):
    jm, tm, (q, _, _) = _case(name)
    rng = np.random.default_rng(3)
    d = rng.uniform(-0.7, 0.7, q.shape[:-1] + (jm.nv,))
    ref = np.stack([np.asarray(jmd.md_tangent_apply(
        jm, jnp.asarray(qi), jnp.asarray(di)))
        for qi, di in zip(q.reshape(-1, jm.nq), d.reshape(-1, jm.nv))])
    got = gt.md_tangent_apply(tm, torch.from_numpy(q), torch.from_numpy(d))
    assert_close(got.reshape(-1, jm.nq), ref)


# ---------------------------------------------- bodies, wrappers, entries
@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("name", list(ROBOTS))
def test_md_plain_and_wrappers_match_jax(name, fam):
    """The plain body and its wrapper on CPU tensors (batch last) against
    the JAX kernel body (force_xla)."""
    _, tm, s = _case(name)
    k = FAMILIES[fam][4]
    cols = [torch.from_numpy(x.reshape(-1, x.shape[-1]).T.copy())
            for x in s[:k]]
    refs = [r.reshape((-1,) + r.shape[len(BATCH):]) for r in
            _jax_ref(name, fam)]
    refs = [np.moveaxis(r, 0, -1) for r in refs]
    for fn in FAMILIES[fam][2:4]:
        got = _as_tuple(fn(tm, *cols))
        assert len(got) == len(refs)
        for g_, r_ in zip(got, refs):
            assert_close(g_, r_)


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("name", list(ROBOTS))
def test_md_batched_entries_match_jax(name, fam):
    """The public entry points on a (2, 3) leading batch."""
    _, tm, s = _case(name)
    k = FAMILIES[fam][4]
    got = _as_tuple(FAMILIES[fam][1](tm, *(torch.from_numpy(x)
                                           for x in s[:k])))
    refs = _jax_ref(name, fam)
    assert len(got) == len(refs)
    for g_, r_ in zip(got, refs):
        assert_close(g_, r_)


@pytest.mark.parametrize("fam", ["id", "aba", "fd_grad"])
def test_md_armature_matches_jax(fam):
    """A nonzero armature on every joint of the ball arm: the k×k joint
    blocks of ABA and the diagonal of the CRBA in ∇FD."""
    _, tm, s = _case("ball", ARMATURE)
    k = FAMILIES[fam][4]
    got = _as_tuple(FAMILIES[fam][1](tm, *(torch.from_numpy(x)
                                           for x in s[:k])))
    for g_, r_ in zip(got, _jax_ref("ball", fam, ARMATURE)):
        assert_close(g_, r_)


def test_free_hyq_fd_grad_vs_central_differences():
    """Free HyQ (n 13, nv 18): ∂q̈/∂δq and ∂q̈/∂q̇ against central
    differences of the port's own ABA along md_tangent_apply, ∂q̈/∂u
    against ABA's response to u, at 1e-6."""
    m = gt.multidof_model_from_description(
        gt.parse_urdf(tzoo.with_free_joint(tzoo.hyq(damping=0.1))),
        dtype=torch.float64, device="cpu")
    B, nv, h = 2, m.nv, 1e-6
    gen = torch.Generator().manual_seed(7)

    def uni(r):
        return torch.rand((B, nv), generator=gen, dtype=torch.float64) \
            * (2 * r) - r
    q = gt.md_tangent_apply(m, gt.neutral_q(m).expand(B, -1), uni(0.6))
    qd, u = uni(0.8), uni(5.0)
    J = gt.md_forward_dynamics_gradient_batched(m, q, qd, u)
    dirs = (torch.eye(nv, dtype=torch.float64) * h)[:, None].expand(
        nv, B, nv)
    rep = lambda x: x[None].expand(nv, B, x.shape[-1])
    fd = []
    for side in range(3):
        outs = []
        for sign in (1.0, -1.0):
            x = [rep(q), rep(qd), rep(u)]
            if side == 0:
                x[0] = gt.md_tangent_apply(m, x[0], sign * dirs)
            else:
                x[side] = x[side] + sign * dirs
            outs.append(gt.md_forward_dynamics_batched(m, *x))
        fd.append(((outs[0] - outs[1]) / (2 * h)).permute(1, 2, 0))
    for got, ref in zip(J, fd):
        err = ((got - ref).abs().amax((1, 2))
               / ref.abs().amax((1, 2)).clamp(min=1.0))
        assert float(err.max()) <= 1e-6, float(err.max())


# ------------------------------------------------------------- routing
def _meta_call(fam, tm):
    q = torch.empty((tm.nq, 3), dtype=torch.float64, device="meta")
    v = torch.empty((tm.nv, 3), dtype=torch.float64, device="meta")
    return {"id": lambda: tmf.md_id_fused(tm, q, v, v),
            "bias": lambda: tmf.md_id_fused(tm, q, v),
            "aba": lambda: tmf.md_aba_fused(tm, q, v, v),
            "id_grad": lambda: tmf.md_id_grad_fused(tm, q, v, v),
            "fd_grad": lambda: tmf.md_fd_grad_fused(tm, q, v, v),
            "crba": lambda: tmf.md_fd_fused(tm, q, v, v)}[fam]()


@pytest.mark.parametrize("fam", ["id", "bias", "aba", "id_grad", "fd_grad",
                                 "crba"])
def test_md_no_fallback_off_cpu(fam):
    """Tensors on neither the CPU nor a CUDA device raise: no wrapper runs
    its plain version off the CPU, and nothing is counted."""
    _, tm, _ = _case("ball")
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _meta_call(fam, tm)
    assert _launch.LAUNCHES == before


def test_md_cpu_runs_plain_without_launch():
    _, tm, s = _case("mixed")
    before = dict(_launch.LAUNCHES)
    for fam in FAMILIES:
        k = FAMILIES[fam][4]
        FAMILIES[fam][1](tm, *(torch.from_numpy(x) for x in s[:k]))
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize("fam", ["id", "aba", "id_grad", "fd_grad"])
def test_md_impl_cuda_on_cpu_raises(fam):
    _, tm, s = _case("ball")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        FAMILIES[fam][1](tm, *(torch.from_numpy(x) for x in s), impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        FAMILIES[fam][1](tm, *(torch.from_numpy(x) for x in s), impl="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FAMILIES[fam][1](tm, *(torch.from_numpy(x) for x in s), impl="vmap")


def test_md_unported_options_raise():
    """The per-state tier still raises; the two options that raised until
    the staged multi-dof slice now run: ``impl="crba"`` returns ABA's q̈,
    and free Atlas (nv 34, past MAX_MD_GRAD_NV) gets both tangent-space
    gradients, finite, from the staged pipeline."""
    _, tm, s = _case("ball")
    t = [torch.from_numpy(x) for x in s]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.md_forward_dynamics_batched(tm, *t, impl="vmap")
    crba = gt.md_forward_dynamics_batched(tm, *t, impl="crba").numpy()
    aba = _jax_ref("ball", "aba")[0]
    assert crba.shape == aba.shape
    # another recursion for the same q̈: round-off apart
    assert np.all(np.abs(crba - aba) <= 1e-9 * np.maximum(1.0, np.abs(aba)))
    big = gt.multidof_model_from_description(
        gt.parse_urdf(tzoo.with_free_joint(tzoo.atlas(damping=0.1))),
        dtype=torch.float64, device="cpu")
    assert big.nv > _build.MAX_MD_GRAD_NV
    q = gt.md_tangent_apply(big, gt.neutral_q(big).expand(2, -1),
                            torch.full((2, big.nv), 0.1,
                                       dtype=torch.float64))
    v = torch.full((2, big.nv), 0.2, dtype=torch.float64)
    outs = (*gt.md_id_grad_batched(big, q, v, v),
            *gt.md_forward_dynamics_gradient_batched(big, q, v, v))
    assert len(outs) == 5
    for o in outs:
        assert tuple(o.shape) == (2, big.nv, big.nv)
        assert bool(torch.isfinite(o).all())
    # ID and ABA run at every size
    assert gt.md_forward_dynamics_batched(big, q, v, v).shape == (2, big.nv)


@pytest.mark.parametrize("case", ["q_width", "qd_width", "qdd_width",
                                  "batch", "scalar"])
def test_md_shape_errors_name_nq_nv(case):
    _, tm, s = _case("ball")
    q, qd, u = (torch.from_numpy(x) for x in s)
    args = {"q_width": (qd, qd, u), "qd_width": (q, q, u),
            "qdd_width": (q, qd, q), "batch": (q, qd[:1], u),
            "scalar": (q, torch.tensor(1.0), u)}[case]
    match = {"q_width": "q must have trailing dimension nq=9",
             "qd_width": "qd must have trailing dimension nv=7",
             "qdd_width": "qdd must have trailing dimension nv=7",
             "batch": "batch shapes disagree",
             "scalar": "qd must have trailing dimension nv=7"}[case]
    with pytest.raises(ValueError, match=match):
        gt.md_inverse_dynamics_batched(tm, *args)


def test_md_build_keys_differ():
    """A ball root and a free root under the same parents (and iiwa-14's
    single-dof model) get different libraries: key, macros and digest."""
    free = tzoo.with_free_joint(tzoo.iiwa14())
    ball = free.replace('type="floating"', 'type="spherical"')
    models = {
        "free": gt.multidof_model_from_description(gt.parse_urdf(free),
                                                   device="cpu"),
        "ball": gt.multidof_model_from_description(gt.parse_urdf(ball),
                                                   device="cpu"),
    }
    assert models["free"].topology.parents == models["ball"].topology.parents
    keys = {k: _build.topology_key(m) for k, m in models.items()}
    keys["iiwa"] = _build.topology_key(gt.load_robot(tzoo.iiwa14(),
                                                     device="cpu"))
    assert len(set(keys.values())) == 3
    macros = {k: tuple(_build._macros(v)) for k, v in keys.items()}
    assert len(set(macros.values())) == 3
    assert "-DGRID_JTYPES=G(3)" + "G(0)" * 7 in macros["free"]
    assert "-DGRID_JTYPES=G(2)" + "G(0)" * 7 in macros["ball"]
    assert len({_build._digest(v) for v in keys.values()}) == 3
    assert _build._units(keys["free"]) == ("md.cu",)
    assert "md.cu" not in _build._units(keys["iiwa"])
