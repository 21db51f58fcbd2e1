"""Forward dynamics by ABA: the port's ``forward_dynamics_aba_fused`` on CPU
tensors (its plain version, ``ops/aba.aba_bl``) against the JAX package in
float64 — the Pallas kernel in interpret mode (as tests/test_aba.py runs
it) and the JAX ``aba_bl`` — with damping and armature, and against the
golden model. Tolerance 1e-10·max(1, |ref|) per element against JAX (the
same sums in the same order), 1e-9 against the golden model.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup, random_state
from gridcodegenerator_tpu.ops import aba as jaba
from gridcodegenerator_tpu.ops.kernels import fused as jf
from gridcodegenerator_tpu_torch.ops import aba as taba
from gridcodegenerator_tpu_torch.ops.kernels import fused as tf

torch.set_num_threads(1)

B = 5


def assert_close(got, ref, tol=1e-10):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


@functools.cache
def _models(name):
    """JAX and port models of one robot, with nonzero armature added to
    both descriptions (the zoo URDFs carry damping, not armature)."""
    jdesc = g.parse_urdf(ROBOTS[name])
    tdesc = gt.parse_urdf(ROBOTS[name])
    arm = np.linspace(0.02, 0.08, jdesc.n)
    jm = g.robot_model_from_description(
        dataclasses.replace(jdesc, armature=arm), dtype=jnp.float64)
    tm = gt.robot_model_from_description(
        dataclasses.replace(tdesc, armature=arm), dtype=torch.float64,
        device="cpu")
    q, qd, u = (x.T.copy() for x in random_state(jdesc.n, seed=41,
                                                  batch=(B,)))
    return jm, tm, q, qd, u


@pytest.mark.parametrize("name", ["barm", "chain5p"])
def test_aba_fused_matches_jax_interpret(name):
    """Sibling arms under a moving torso, and a chain with prismatic
    joints: the port's wrapper against the Pallas kernel body run in
    interpret mode (block_b=4: a padded second tile)."""
    jm, tm, q, qd, u = _models(name)
    assert np.all(np.asarray(jm.armature) > 0)
    assert np.any(np.asarray(jm.damping) > 0)
    ref = jf.forward_dynamics_aba_fused(jm, *(jnp.asarray(x) for x in
                                              (q, qd, u)),
                                        block_b=4, interpret=True)
    got = tf.forward_dynamics_aba_fused(tm, *(torch.from_numpy(x) for x in
                                              (q, qd, u)))
    assert_close(got, ref)


@pytest.mark.parametrize("name", ["atlas", "dpend", "iiwa14"])
def test_aba_bl_matches_jax(name):
    """The plain body against the JAX batch-last one, Atlas's forest
    included, at a nonzero gravity other than the default."""
    jm, tm, q, qd, u = _models(name)
    ref = jaba.aba_bl(jm, *(jnp.asarray(x) for x in (q, qd, u)),
                      gravity=-3.7)
    got = taba.aba_bl(tm, *(torch.from_numpy(x) for x in (q, qd, u)),
                      gravity=-3.7)
    assert_close(got, ref)


@pytest.mark.parametrize("name", ["atlas", "barm", "chain5p"])
def test_aba_matches_golden(name):
    """Without armature (the golden model has none): ABA is the
    M⁻¹·(u − c) forward dynamics of the golden model."""
    desc, gold, _ = get_setup(name)
    q, qd, u = random_state(desc.n, seed=43, batch=(B,))
    tm = gt.load_robot(ROBOTS[name], dtype=torch.float64, device="cpu")
    got = tf.forward_dynamics_aba_fused(
        tm, *(torch.from_numpy(x.T.copy()) for x in (q, qd, u))).numpy()
    for s in range(B):
        ref = gold.fd(q[s], qd[s], u[s])
        assert np.abs(got[:, s] - ref).max() <= \
            1e-9 * max(1.0, np.abs(ref).max())
