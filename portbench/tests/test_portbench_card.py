"""On the card (``-m card``): one short run of each cell through the
benchmark's own command and its result line, and the control run in the
program's place at the cell's own batch."""

import json
import subprocess
import sys

import pytest

from portbench import harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_on_the_card(root, card, name, traced):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 7), "--seconds", "3", "--trace", str(traced)],
        capture_output=True, text=True, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    cell = registry.cell(name, root)
    want = cell.per_layer if traced else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
    if traced:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_batch(root, card, name):
    """The reference in TF32 answers the window's whole batches, at the
    cell's own size, and the run's own check, over as many states as a run
    of the program compares, finds it not correct."""
    cell = registry.cell(name, root)
    r = harness.run(cell, 2**31 + 13, 1.0, False,
                    fn=harness.control(cell, card),
                    overrides=harness.control_overrides(cell.traffic))
    harness.log(f"control {name}: {r['checks']}")
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["checked_states"] == cell.traffic["sample"]["max_states"]
    assert not r["correct"]
    assert r["checks"]["gap"]["value"] > r["checks"]["gap"]["limit"]
