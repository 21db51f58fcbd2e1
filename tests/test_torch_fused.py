"""The port's four kernel wrappers on CPU tensors (their plain versions)
against the JAX package's fused Pallas kernels in interpret mode, float64,
on 5 states with block_b=4 (a padded second tile) — as tests/test_blops.py
runs the kernels. Also: the wrappers never fall back from the kernel route.

Tolerance 1e-10·max(1, |ref|) per element: the same sums in the same order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup, random_state
from gridcodegenerator_tpu.ops.kernels import fused as jf
from gridcodegenerator_tpu_torch.ops.kernels import _launch
from gridcodegenerator_tpu_torch.ops.kernels import fused as tf
from gridcodegenerator_tpu_torch.ops.kernels import staged as ts

torch.set_num_threads(1)

B = 5


def assert_close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= 1e-10 * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


@functools.cache
def _case(name):
    desc, _, jm = get_setup(name)
    q, qd, u = (x.T.copy() for x in random_state(desc.n, seed=71, batch=(B,)))
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    return jm, tm, q, qd, u


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# interpret mode compiles the whole kernel body per call, so each wrapper
# runs on the cheapest robot that exercises it: sibling arms under a moving
# torso for RNEA and M⁻¹ (accumulation into a shared parent), the double
# pendulum for the two gradients
def test_inverse_dynamics_fused():
    jm, tm, q, qd, u = _case("barm")
    ref = jf.inverse_dynamics_fused(jm, *_j(q, qd, u), block_b=4,
                                    interpret=True)
    assert_close(tf.inverse_dynamics_fused(tm, *_t(q, qd, u)), ref)


def test_bias_force_fused():
    jm, tm, q, qd, _ = _case("dpend")
    ref = jf.inverse_dynamics_fused(jm, *_j(q, qd), None, block_b=4,
                                    interpret=True)
    assert_close(tf.inverse_dynamics_fused(tm, *_t(q, qd), None), ref)


def test_minv_fused():
    jm, tm, q, _, _ = _case("barm")
    ref = jf.minv_fused(jm, jnp.asarray(q), block_b=4, interpret=True)
    assert_close(tf.minv_fused(tm, torch.from_numpy(q)), ref)


def test_id_grad_fused():
    jm, tm, q, qd, u = _case("dpend")
    ref = jf.id_grad_fused(jm, *_j(q, qd, u), block_b=4, interpret=True)
    got = tf.id_grad_fused(tm, *_t(q, qd, u))
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


def test_fd_grad_fused():
    jm, tm, q, qd, u = _case("dpend")
    ref = jf.fd_grad_fused(jm, *_j(q, qd, u), block_b=4, interpret=True)
    got = tf.fd_grad_fused(tm, *_t(q, qd, u))
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


# ---------------------------------------------------------------- routing
def _meta_call(wrapper, tm):
    """Call ``wrapper`` on tensors that are neither on the CPU nor on a
    CUDA device: it must raise, not run the plain version."""
    n = tm.n
    st = torch.empty((n, 3), dtype=torch.float64, device="meta")
    vaf = torch.empty((6, n, 3), dtype=torch.float64, device="meta")
    M = torch.empty((n, n, 3), dtype=torch.float64, device="meta")
    calls = {
        "minv": lambda: tf.minv_fused(tm, st),
        "fd_grad": lambda: tf.fd_grad_fused(tm, st, st, st),
        "id_grad": lambda: tf.id_grad_fused(tm, st, st),
        "inverse_dynamics": lambda: tf.inverse_dynamics_fused(tm, st, st),
        "aba": lambda: tf.forward_dynamics_aba_fused(tm, st, st, st),
        "bias_and_v": lambda: ts.bias_and_v_staged(tm, st, st),
        "minv_dense": lambda: ts.minv_qdd_dense_staged(tm, st, st),
        "af": lambda: ts.af_staged(tm, st, st, st, vaf),
        "vaf": lambda: ts.vaf_staged(tm, st, st, st),
        "grad_cols": lambda: ts.grad_cols_staged(tm, st, st, vaf, vaf, vaf),
        "grad_cols_finish": lambda: ts.grad_cols_staged(
            tm, st, st, vaf, vaf, vaf, Minv=M),
        "id_grad_staged": lambda: ts.id_grad_staged(tm, st, st, st),
        "fd_grad_staged": lambda: ts.fd_grad_staged(tm, st, st, st),
    }
    calls[wrapper]()


# every wrapper of both modules
@pytest.mark.parametrize("wrapper",
                         ["inverse_dynamics", "minv", "id_grad", "fd_grad",
                          "aba", "bias_and_v", "minv_dense", "af", "vaf",
                          "grad_cols", "grad_cols_finish", "id_grad_staged",
                          "fd_grad_staged"])
def test_no_fallback_off_cpu(wrapper):
    tm = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64, device="cpu")
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _meta_call(wrapper, tm)
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["minv", "id_grad", "fd_grad", "aba",
                                     "inverse_dynamics"])
def test_no_fallback_off_cpu_atlas(wrapper):
    """On Atlas the ∇FD, ∂ID and M⁻¹ wrappers route to the staged ones
    first; neither route falls back to a plain version."""
    tm = gt.load_robot(ROBOTS["atlas"], dtype=torch.float64, device="cpu")
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _meta_call(wrapper, tm)
    assert _launch.LAUNCHES == before


def test_cpu_runs_plain_without_launch():
    _, tm, q, qd, u = _case("dpend")
    before = dict(_launch.LAUNCHES)
    tf.fd_grad_fused(tm, *_t(q, qd, u))
    tf.minv_fused(tm, torch.from_numpy(q))
    tf.forward_dynamics_aba_fused(tm, *_t(q, qd, u))
    ts.fd_grad_staged(tm, *_t(q, qd, u))
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize("fn", ["forward_dynamics_gradient",
                                "inverse_dynamics_gradient",
                                "inverse_dynamics", "bias_force",
                                "direct_minv", "forward_dynamics"])
def test_impl_cuda_on_cpu_raises(fn):
    _, tm, q, qd, u = _case("dpend")
    states = {"direct_minv": (q.T,), "bias_force": (q.T, qd.T)}.get(
        fn, (q.T, qd.T, u.T))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        getattr(gt, fn)(tm, *(torch.from_numpy(s.copy()) for s in states),
                        impl="cuda")
