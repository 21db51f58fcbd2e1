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
from gridcodegenerator_tpu_torch.ops.kernels import fused as tf

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
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64)
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
    args = {"minv": (st,), "fd_grad": (st, st, st)}.get(wrapper, (st, st))
    getattr(tf, f"{wrapper}_fused")(tm, *args)


@pytest.mark.parametrize("wrapper",
                         ["inverse_dynamics", "minv", "id_grad", "fd_grad"])
def test_no_fallback_off_cpu(wrapper):
    tm = gt.load_robot(ROBOTS["dpend"], dtype=torch.float64)
    before = dict(tf.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _meta_call(wrapper, tm)
    assert tf.LAUNCHES == before


def test_cpu_runs_plain_without_launch():
    _, tm, q, qd, u = _case("dpend")
    before = dict(tf.LAUNCHES)
    tf.fd_grad_fused(tm, *_t(q, qd, u))
    tf.minv_fused(tm, torch.from_numpy(q))
    assert tf.LAUNCHES == before


@pytest.mark.parametrize("fn", ["forward_dynamics_gradient",
                                "inverse_dynamics_gradient",
                                "inverse_dynamics", "bias_force",
                                "direct_minv"])
def test_impl_cuda_on_cpu_raises(fn):
    _, tm, q, qd, u = _case("dpend")
    states = {"direct_minv": (q.T,), "bias_force": (q.T, qd.T)}.get(
        fn, (q.T, qd.T, u.T))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        getattr(gt, fn)(tm, *(torch.from_numpy(s.copy()) for s in states),
                        impl="cuda")
