"""The slice as a whole: the port's public API against the JAX API
(``impl="bl"``) in float64, against the golden model in float32, its shape
errors, and a process that has no jax at all."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gridcodegenerator_tpu as g
import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS, get_setup, random_state
from gridcodegenerator_tpu_torch.models import zoo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# number of state arguments of each API family
FAMILIES = {
    "forward_dynamics_gradient": 3,
    "inverse_dynamics_gradient": 3,
    "inverse_dynamics": 3,
    "bias_force": 2,
    "direct_minv": 1,
    "forward_dynamics": 3,
}


def assert_close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= 1e-10 * np.maximum(1.0, np.abs(ref))), \
        f"max err {err.max():.3e}"


@functools.cache
def _tmodel(name, dtype=torch.float64):
    return gt.load_robot(ROBOTS[name], dtype=dtype, device="cpu")


def _states(name, batch, k):
    desc = get_setup(name)[0]
    return random_state(desc.n, seed=5, batch=batch)[:k]


# every family on a batch; the north-star op also on leading dims and on a
# single state (the JAX API runs its vmap tier there)
CASES = ([(fam, (4,)) for fam in FAMILIES if fam != "forward_dynamics"]
         + [("forward_dynamics_gradient", (2, 3)),
            ("forward_dynamics_gradient", ()),
            ("forward_dynamics", (4,)), ("forward_dynamics", (2, 3)),
            ("forward_dynamics", ())])


@pytest.mark.parametrize("fam,batch", CASES)
def test_api_matches_jax(fam, batch):
    name = "dpend"
    states = _states(name, batch, FAMILIES[fam])
    ref = getattr(g, fam)(get_setup(name)[2],
                          *(jnp.asarray(s) for s in states), impl="bl")
    got = getattr(gt, fam)(_tmodel(name),
                           *(torch.from_numpy(s) for s in states))
    assert_close(got, ref)


@pytest.mark.parametrize("name", ["iiwa14", "barm", "chain5p"])
def test_api_matches_golden(name):
    """Every family of the slice against the float64 golden model."""
    _, gold, _ = get_setup(name)
    q, qd, u = _states(name, (3,), 3)
    m = _tmodel(name)
    tq, tqd, tu = (torch.from_numpy(s) for s in (q, qd, u))
    out = {
        "fdg": gt.forward_dynamics_gradient(m, tq, tqd, tu),
        "idg": gt.inverse_dynamics_gradient(m, tq, tqd, tu),
        "id": gt.inverse_dynamics(m, tq, tqd, tu),
        "bias": gt.bias_force(m, tq, tqd),
        "minv": gt.direct_minv(m, tq),
        "fd": gt.forward_dynamics(m, tq, tqd, tu),
    }
    for k in range(3):
        ref = {
            "fdg": gold.fd_grad(q[k], qd[k], u[k]),
            "idg": np.hstack(gold.rnea_grad(q[k], qd[k], u[k])),
            "id": gold.rnea(q[k], qd[k], u[k])[0],
            "bias": gold.rnea(q[k], qd[k], None)[0],
            "minv": gold.minv(q[k], True),
            "fd": gold.fd(q[k], qd[k], u[k]),
        }
        for key, r in ref.items():
            got = out[key][k].numpy()
            assert np.abs(got - r).max() <= 1e-9 * max(1.0, np.abs(r).max()), key


def test_f32_parity_head_vs_golden():
    """bench.py's parity protocol on the port's f32 plain path: the same
    256 iiwa-14 states bench.py scores (its jax.random inputs, key 0), each
    scored as max|J − J_golden| / max(1, max|J_golden|); the bound is the
    one fused.py's ∇FD docstring names."""
    n, P = 7, 256
    ks = jax.random.split(jax.random.key(0), 3)
    q, qd, u = (np.array(jax.random.uniform(k, (1 << 16, n), jnp.float32,
                                             -r, r)[:P])
                for k, r in zip(ks, (2.0, 1.0, 8.0)))
    gold = gt.GoldenDynamics(gt.parse_urdf(zoo.iiwa14()))
    J = gt.forward_dynamics_gradient(
        gt.load_robot(zoo.iiwa14(), dtype=torch.float32, device="cpu"),
        *(torch.from_numpy(s) for s in (q, qd, u))).numpy()
    errs = []
    for k in range(P):
        ref = gold.fd_grad(*(s[k].astype(np.float64) for s in (q, qd, u)))
        errs.append(np.abs(J[k] - ref).max() / max(1.0, np.abs(ref).max()))
    assert max(errs) <= 5e-6


# ------------------------------------------------------------ shape errors
BAD = {
    "wrong width": lambda n: [(4, n + 1), (4, n), (4, n)],
    "scalar": lambda n: [(), (n,), (n,)],
    "batch mismatch": lambda n: [(4, n), (3, n), (4, n)],
    "lead mismatch": lambda n: [(2, 3, n), (3, 2, n), (2, 3, n)],
}


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("fam", ["forward_dynamics_gradient",
                                 "inverse_dynamics", "forward_dynamics"])
def test_check_states_errors_match_jax(case, fam):
    jm = get_setup("iiwa14")[2]
    shapes = BAD[case](jm.n)
    with pytest.raises(ValueError) as ref:
        getattr(g, fam)(jm, *(np.zeros(s) for s in shapes))
    with pytest.raises(ValueError) as got:
        getattr(gt, fam)(_tmodel("iiwa14"),
                         *(torch.zeros(s, dtype=torch.float64)
                           for s in shapes))
    assert str(got.value) == str(ref.value)


def test_unported_options_raise():
    m = _tmodel("dpend")
    q = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.forward_dynamics_gradient(m, q, q, q, impl="vmap")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.inverse_dynamics(m, q, q, q, f_ext=torch.zeros((3, 2, 6)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.direct_minv(m, q, dense=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.forward_dynamics(m, q, q, q, f_ext=torch.zeros((3, 2, 6)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.forward_dynamics(m, q, q, q, impl="vmap")
    with pytest.raises(ValueError, match="impl must be one of"):
        gt.forward_dynamics_gradient(m, q, q, q, impl="pallas")


def test_unported_messages_name_roadmap_items_by_title():
    """The "not ported yet" errors name their ROADMAP items by title, which
    a renumbering of the queues leaves as it is."""
    m = _tmodel("dpend")
    q = torch.zeros((3, 2), dtype=torch.float64)
    tier = "ROADMAP Queue 1, 'The per-state tier and differentiability'"
    for call in (lambda: gt.forward_dynamics(m, q, q, q, impl="vmap"),
                 lambda: gt.inverse_dynamics(m, q, q, q,
                                             f_ext=torch.zeros((3, 2, 6)))):
        with pytest.raises(NotImplementedError) as e:
            call()
        assert tier in str(e.value)
    with pytest.raises(NotImplementedError) as e:
        gt.direct_minv(m, q, dense=False)
    assert ("ROADMAP Queue 1, 'The rest of the first-order API contract'"
            in str(e.value))


PORT_MODULES = ("api", "ops.blops", "ops.aba", "ops.so", "ops.kernels._build",
                "ops.kernels._launch", "ops.kernels.fused", "ops.kernels.staged",
                "ops.kernels.so_fused", "ops.kernels.so_staged",
                "ops.kernels.contact_fused", "ops.multidof", "ops.md_blops",
                "ops.freeflyer", "ops.contact", "ops.terrain",
                "ops.kernels.multidof_fused", "ops.kernels.multidof_staged",
                "ops.collision", "ops.loops", "ops.md_contact",
                "ops.kernels.md_contact_fused", "models.mjcf",
                "models.robot", "utils.golden")


def test_port_imports_no_jax():
    """The port runs in a process where importing jax fails: every module,
    the single-kernel families on iiwa-14 and the staged ones on Atlas, the
    fixed-base M⁻¹ and FD variants and the staged pipelines' options (on
    the branched arm), the
    three second-order entries (on the double pendulum, to stay quick), the
    four multi-dof entries (on the ball arm), the two multi-dof
    gradients of free Atlas (the staged multi-dof pipeline), the
    free-flyer FD and stance FD, the ground step (flat and on a
    heightfield, with ground geoms, with a collision set and with loop
    closures) and its rollout (on the 3-link chain), and the multi-dof ground step on the ball ant parsed from its
    MJCF document, with its torso sphere."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "import gridcodegenerator_tpu_torch as gt\n"
        "from gridcodegenerator_tpu_torch.models import zoo\n"
        f"for mod in {PORT_MODULES!r}:\n"
        "    importlib.import_module('gridcodegenerator_tpu_torch.' + mod)\n"
        "for urdf, n in ((zoo.iiwa14(), 7), (zoo.atlas(), 28)):\n"
        "    m = gt.load_robot(urdf, dtype=torch.float64, device='cpu')\n"
        "    q = torch.zeros((3, n), dtype=torch.float64)\n"
        "    J = gt.forward_dynamics_gradient(m, q, q, q)\n"
        "    a = gt.forward_dynamics(m, q, q, q)\n"
        "    assert J.shape == (3, n, 2 * n) and a.shape == (3, n)\n"
        "    assert bool(torch.isfinite(J).all() & torch.isfinite(a).all())\n"
        "from gridcodegenerator_tpu_torch.ops.kernels import fused, staged\n"
        "m = gt.load_robot(zoo.branched_arm(), dtype=torch.float64, "
        "device='cpu')\n"
        "q = torch.full((9, 2), 0.3, dtype=torch.float64)\n"
        "outs = (fused.forward_dynamics_fused(m, q, q, q),\n"
        "        staged.fd_staged(m, q, q, q), staged.minv_staged(m, q),\n"
        "        staged.fd_dense_staged(m, q, q, q),\n"
        "        *fused.fd_grad_fused(m, q, q, q, minv_impl='dense'),\n"
        "        *staged.fd_grad_staged(m, q, q, q, minv_impl='recursion', "
        "merge_sides=False, fuse_finish=False, "
        "stage_dtype=torch.bfloat16),\n"
        "        *staged.fd_grad_staged(m, q, q, q, merge_af=True),\n"
        "        *staged.id_grad_staged(m, q, q, q, merge_sides=False, "
        "stage_dtype=torch.bfloat16),\n"
        "        *staged.minv_qdd_af_dense_staged(m, q, q, q, "
        "torch.zeros((6, 9, 2), dtype=torch.float64)))\n"
        "assert [tuple(o.shape)[:2] for o in outs] == [(9, 2)] * 2 + "
        "[(9, 9)] + [(9, 2)] + [(9, 9)] * 8 + [(9, 9), (6, 9), (6, 9)]\n"
        "assert all(bool(torch.isfinite(o).all()) for o in outs)\n"
        "m = gt.load_robot(zoo.double_pendulum(), dtype=torch.float64, "
        "device='cpu')\n"
        "q = torch.full((3, 2), 0.3, dtype=torch.float64)\n"
        "outs = (gt.forward_dynamics_gradient_full(m, q, q, q),\n"
        "        gt.forward_dynamics_hessian(m, q, q, q),\n"
        "        gt.forward_dynamics_hessian_vp(m, q, q, q, q))\n"
        "assert [tuple(o.shape) for o in outs] == [(3, 2, 6), (3, 2, 6, 6), "
        "(3, 6, 6)]\n"
        "assert all(bool(torch.isfinite(o).all()) for o in outs)\n"
        "m = gt.multidof_model_from_description(gt.parse_urdf(zoo.ball_arm("
        "damping=0.1)), dtype=torch.float64, device='cpu')\n"
        "q = gt.md_tangent_apply(m, gt.neutral_q(m).expand(3, -1), "
        "torch.full((3, m.nv), 0.2, dtype=torch.float64))\n"
        "v = torch.full((3, m.nv), 0.3, dtype=torch.float64)\n"
        "outs = (gt.md_inverse_dynamics_batched(m, q, v, v),\n"
        "        gt.md_forward_dynamics_batched(m, q, v, v),\n"
        "        *gt.md_id_grad_batched(m, q, v, v),\n"
        "        *gt.md_forward_dynamics_gradient_batched(m, q, v, v))\n"
        "assert [tuple(o.shape) for o in outs] == [(3, 7)] * 2 + [(3, 7, 7)]"
        " * 5\n"
        "assert all(bool(torch.isfinite(o).all()) for o in outs)\n"
        "m = gt.multidof_model_from_description(gt.parse_urdf("
        "zoo.with_free_joint(zoo.atlas())), dtype=torch.float64, "
        "device='cpu')\n"
        "q = gt.neutral_q(m).expand(2, -1)\n"
        "v = torch.full((2, m.nv), 0.3, dtype=torch.float64)\n"
        "outs = (*gt.md_id_grad_batched(m, q, v, v),\n"
        "        *gt.md_forward_dynamics_gradient_batched(m, q, v, v))\n"
        "assert [tuple(o.shape) for o in outs] == [(2, 34, 34)] * 5\n"
        "assert all(bool(torch.isfinite(o).all()) for o in outs)\n"
        "from gridcodegenerator_tpu_torch.ops import contact, freeflyer\n"
        "m = freeflyer.free_flyer_model(gt.parse_urdf(zoo.serial_chain(3)), "
        "device='cpu')\n"
        "quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2, dtype=torch.float64)\n"
        "q = torch.full((2, 3), 0.2, dtype=torch.float64)\n"
        "vb = torch.full((2, 6), 0.1, dtype=torch.float64)\n"
        "pos = torch.zeros((2, 3), dtype=torch.float64)\n"
        "outs = (*freeflyer.fb_forward_dynamics_batched(m, quat, q, vb, q, q),\n"
        "        *freeflyer.fb_forward_dynamics_batched(m, quat, q, vb, q, q, "
        "impl='chol'),\n"
        "        *gt.fb_constrained_fd_batched(m, quat, pos, q, vb, q, q, (2,), "
        "[[0.1, 0.0, 0.0]]))\n"
        "assert [tuple(o.shape) for o in outs] == [(2, 6), (2, 3)] * 3 + "
        "[(2, 3)]\n"
        "assert all(bool(torch.isfinite(o).all()) for o in outs)\n"
        "terr = gt.bumpy_terrain(extent=2.0, cell=0.25, dtype=torch.float64, "
        "device='cpu')\n"
        "state = (quat, pos, q, vb, q)\n"
        "for kw in ({}, {'terrain': terr}):\n"
        "    nxt, imp = gt.fb_step_ground_batched(m, state, q, 1e-3, (2,), "
        "[[0.1, 0.0, 0.0]], **kw)\n"
        "    assert [tuple(o.shape) for o in (*nxt, imp)] == [(2, 4), (2, 3), "
        "(2, 3), (2, 6), (2, 3), (2, 1, 3)]\n"
        "    assert all(bool(torch.isfinite(o).all()) for o in (*nxt, imp))\n"
        "final, imps = gt.fb_simulate_ground_batched(m, state, q.expand(3, -1,"
        " -1), 1e-3, (2,), [[0.1, 0.0, 0.0]])\n"
        "assert tuple(imps.shape) == (3, 2, 1, 3)\n"
        "gg = gt.make_geoms((-1, 1), [[0.0, 0.0, 0.0]] * 2, [[0.0, 0.0, 0.0], "
        "[0.3, 0.0, 0.0]], [0.15, 0.05], dtype=torch.float64, device='cpu')\n"
        "nxt, imp = gt.fb_step_ground_batched(m, state, q, 1e-3, (2,), "
        "[[0.1, 0.0, 0.0]], ground_geoms=gg, mu_ground=0.6)\n"
        "assert tuple(imp.shape) == (2, 4, 3)\n"
        "assert all(bool(torch.isfinite(o).all()) for o in (*nxt, imp))\n"
        "cm = gt.make_collision_model(gt.make_geoms((0, 2), [[0.0, 0.0, 0.0]]"
        " * 2, r=0.2, dtype=torch.float64, device='cpu'), pairs=((0, 1),), "
        "obstacles=gt.make_obstacles([[0.0, 0.0, 0.0]], r=0.1, "
        "dtype=torch.float64, device='cpu'))\n"
        "nxt, imp = gt.fb_step_ground_batched(m, state, q, 1e-3, (2,), "
        "[[0.1, 0.0, 0.0]], collision=cm, mu_collision=0.5)\n"
        "assert tuple(imp.shape) == (2, 4, 3)\n"
        "assert all(bool(torch.isfinite(o).all()) for o in (*nxt, imp))\n"
        "nxt, imp = gt.fb_step_ground_batched(m, state, q, 1e-3, (2,), "
        "[[0.1, 0.0, 0.0]], loops=(((2, 0), (1, -1)), [[0.1, 0.0, 0.0]] * 2,"
        " [[0.0, 0.0, -0.1], [0.0, 0.0, 0.3]]))\n"
        "assert tuple(imp.shape) == (2, 1, 3)\n"
        "assert all(bool(torch.isfinite(o).all()) for o in (*nxt, imp))\n"
        "src = zoo.ball_ant_mjcf()\n"
        "m = gt.multidof_model_from_description(gt.parse_mjcf(src), "
        "device='cpu')\n"
        "sites = gt.mjcf_sites(src)\n"
        "feet = tuple(sites[f'foot{k}'].link for k in range(4))\n"
        "offs = [list(sites[f'foot{k}'].pos) for k in range(4)]\n"
        "q = gt.neutral_q(m).expand(2, -1).clone()\n"
        "v = torch.zeros((2, m.nv), dtype=torch.float64)\n"
        "(q2, v2), imp = gt.md_step_ground_batched(m, q, v, v, 2e-3, feet, "
        "offs, mu=0.7, ground_geoms=gt.make_geoms([0], [[0.0, 0.0, 0.0]], "
        "r=0.18, dtype=torch.float64, device='cpu'), mu_ground=0.6)\n"
        "assert [tuple(o.shape) for o in (q2, v2, imp)] == [(2, 27), (2, 22), "
        "(2, 5, 3)]\n"
        "assert all(bool(torch.isfinite(o).all()) for o in (q2, v2, imp))\n"
        "assert not any(k == 'gridcodegenerator_tpu' or k.startswith("
        "'gridcodegenerator_tpu.') for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
