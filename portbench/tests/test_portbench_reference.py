"""Each entry's reference against the program's plain versions on the CPU
(float64, a few states), and the reference's independence: it imports
neither JAX, the JAX package nor anything of the program."""

import ast

import pytest
import torch

import gridcodegenerator_tpu_torch as port
from portbench import harness, registry
from portbench.reference import _rbd

ENTRIES = ("forward_dynamics_gradient", "inverse_dynamics_gradient",
           "forward_dynamics_hessian_vp")
# the benchmark's robot, and a branched tree (the program's stylised
# humanoid, written out for the test) so that the reference's tree code is
# held too
ROBOTS = ("iiwa14", "zoo_atlas")
RANGES = {"q": 2.0, "qd": 1.0, "u": 8.0, "qdd": 8.0, "lam": 1.0}


@pytest.fixture(scope="module")
def robot_file(root, tmp_path_factory):
    def path(name):
        if name == "zoo_atlas":
            from gridcodegenerator_tpu_torch.models import zoo
            p = tmp_path_factory.mktemp("robots") / "atlas.urdf"
            p.write_text(zoo.atlas())
            return str(p)
        return str(root / registry.config(name, root)["robot"])
    return path


@pytest.mark.parametrize("robot", ROBOTS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_reference_matches_the_programs_plain_version(root, robot_file,
                                                      robot, entry):
    ref_mod = registry.reference(entry, root)
    path = robot_file(robot)
    gen = torch.Generator().manual_seed(3)
    m = port.load_robot(path, dtype=torch.float64, device="cpu")
    x = [(torch.rand((3, m.n), generator=gen, dtype=torch.float64) * 2 - 1)
         * RANGES[name] for name in ref_mod.INPUTS]
    dyn = _rbd.Dynamics(_rbd.read_urdf(path))
    ref = ref_mod.reference(dyn, *x)
    out = getattr(port, entry)(m, *x)
    assert out.shape == ref.shape
    assert float(harness.gaps(out, ref).max()) < 1e-11


def test_reader_matches_the_programs_robot(robot_file):
    for robot in ROBOTS:
        path = robot_file(robot)
        r = _rbd.read_urdf(path)
        d = port.parse_urdf(str(path))
        assert r.parents == d.topology.parents
        assert torch.allclose(torch.tensor(r.inertia),
                              torch.tensor(d.inertia), atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0e-5])
    r = _rbd.tf32_round(x)
    # ties to even at the 10th mantissa bit, others to nearest
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 * 2.0 ** -10
    assert r[3] == 1.0 + 2.0 ** -10
    assert abs(r[4] / x[4] - 1) < 2.0 ** -11


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program(root):
    files = sorted((root / "portbench" / "reference").glob("*.py"))
    assert len(files) >= 4
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "flax", "gridcodegenerator_tpu",
                "gridcodegenerator_tpu_torch", "portbench"), (f, name)
