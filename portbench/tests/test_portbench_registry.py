"""Every part of a cell is found by the name BENCHMARK.json gives it, and a
new configuration, mix, entry reference and metric reader are found as new
files, with nothing edited."""

import json
import shutil

import pytest

from portbench import registry

CELLS = ("iiwa14.fdgrad.b262144", "iiwa14.idgrad.b262144",
         "iiwa14.hvp.b65536")


def test_cells_in_order(root):
    names = [w["name"] for w in registry.benchmark(root)["workloads"]]
    assert names == list(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_parts(root, name):
    cell = registry.cell(name, root)
    assert cell.path(cell.config["robot"]).is_file()
    ref = registry.reference(cell.entry, root)
    assert [s["name"] for s in cell.traffic["inputs"]] == list(ref.INPUTS)
    counts = registry.counts(cell.config_name, cell.entry, root)
    assert counts["ops_per_state"] > 0 and counts["bytes_per_state"] > 0
    assert registry.limits(name, root)["numbers"]["gap"]["limit"] > 0
    assert {m["name"] for m in cell.end_to_end} >= {"evals_per_s",
                                                     "setup_s"}
    for m in cell.per_layer:
        assert hasattr(registry.reader(m["name"], root), "read")


def test_metric_lists(root):
    bench = registry.benchmark(root)
    assert [m["name"] for m in bench["end_to_end"]] == [
        "evals_per_s", "call_ms_p95", "peak_mem_gib", "setup_s"]
    assert all(m["moves"] == "evals_per_s" for m in bench["per_layer"])
    # every per-layer metric lists its cells, and each cell reads one
    # roofline, its own entry's
    assert all(m["workloads"] for m in bench["per_layer"])
    for name in CELLS:
        cell = registry.cell(name, root)
        rooflines = [m["name"] for m in cell.per_layer
                     if m["name"].endswith("_roofline")]
        assert rooflines == [cell.traffic_name.split(".")[0] + "_roofline"]
    hvp = registry.cell("iiwa14.hvp.b65536", root)
    assert {m["name"] for m in hvp.per_layer} == {
        "boundary_ms", "launches_per_call", "hvp_roofline",
        "device_idle_pct"}


def test_reader_by_family(root):
    assert registry.reader("fdgrad_roofline", root).__name__.endswith(
        "roofline")
    assert registry.reader("device_idle_pct", root).__name__.endswith(
        "device_idle_pct")


def test_new_parts_are_found_as_new_files(root, tmp_path):
    """A later change adds a configuration, a mix, an entry's reference and
    a per-layer metric as files: copy the benchmark, add them, and look
    each up by name."""
    shutil.copytree(root / "portbench", tmp_path / "portbench")
    bench = registry.benchmark(root)
    (tmp_path / "portbench" / "configs" / "arm2.json").write_text(json.dumps(
        {"robot": "portbench/robots/arm2.urdf", "dtype": "float32"}))
    (tmp_path / "portbench" / "robots" / "arm2.urdf").write_text(
        "<robot name='arm2'/>")
    (tmp_path / "portbench" / "traffic" / "fd.b1024.json").write_text(
        json.dumps({"entry": "forward_dynamics", "batch": 1024,
                    "inputs": []}))
    (tmp_path / "portbench" / "reference" / "forward_dynamics.py").write_text(
        "INPUTS = ('q', 'qd', 'u')\nBLOCK = 8\n"
        "def reference(dyn, q, qd, u):\n    return dyn.fd(q, qd, u)\n")
    (tmp_path / "portbench" / "metrics" / "toy_share.py").write_text(
        "def read(r):\n    return 42.0\n")
    bench["configs"].append({"name": "arm2", "source": "x",
                             "file": "portbench/configs/arm2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "arm2.fd.b1024", "config": "arm2",
                               "traffic": "fd.b1024", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "toy_share", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "x", "moves": "evals_per_s",
                               "workloads": ["arm2.fd.b1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("arm2.fd.b1024", tmp_path)
    assert cell.config["robot"] == "portbench/robots/arm2.urdf"
    assert cell.path(cell.config["robot"]).is_file()
    assert cell.entry == "forward_dynamics"
    assert registry.reference(cell.entry, tmp_path).INPUTS == ("q", "qd", "u")
    assert [m["name"] for m in cell.per_layer] == ["toy_share"]
    assert registry.reader("toy_share", tmp_path).read(None) == 42.0
    # the cells already there are unchanged
    assert registry.cell(CELLS[0], tmp_path).per_layer == registry.cell(
        CELLS[0], root).per_layer
