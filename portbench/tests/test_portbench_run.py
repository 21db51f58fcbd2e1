"""A run on the CPU, the harness's look for a card skipped: the result
line's keys, the modules it loaded, and ``correct`` coming out false when
the timed path is broken underneath (the faults a cell of answers checked
one by one can have) or when the control is put in the program's place."""

import json
import subprocess
import sys

import pytest
import torch

import gridcodegenerator_tpu_torch as port
from portbench import harness, registry, run as runner

SMALL = {"batch": 64, "pool_min_bytes": 0, "warmup_calls": 1}
SEED = 2**31 + 11


def _run(root, name="iiwa14.fdgrad.b262144", fn=None, traced=False,
         seconds=0.5, overrides=SMALL):
    return harness.run(registry.cell(name, root), SEED, seconds, traced,
                       device="cpu", fn=fn, overrides=overrides)


def test_result_line(root):
    r = _run(root)
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "checks"
    assert {"metrics", "device"} <= set(r)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 1
    assert set(r["metrics"]) == {"evals_per_s", "call_ms_p95",
                                 "peak_mem_gib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    assert set(r["checks"]) == {"gap", "failed_calls"}
    json.dumps(r)


def test_traced_result_line(root):
    r = _run(root, traced=True)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the trace holds no device operation: those metrics are
    # left out, the program's counter is read
    assert "launches_per_call" in r["metrics"]
    assert "fdgrad_roofline" not in r["metrics"]


def test_the_run_loads_no_jax(root):
    """A fresh process runs a cell on the CPU and lists what it loaded."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import harness, registry, run\n"
        "r = harness.run(registry.cell('iiwa14.idgrad.b262144', "
        "run.ROOT), 5, 0.2, False, device='cpu', overrides=%r)\n"
        "print(json.dumps([r['correct'], run.forbidden_modules(), "
        "'gridcodegenerator_tpu_torch' in sys.modules]))\n"
        % (str(root), SMALL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == [] and loaded


def test_forbidden_modules_are_compared_by_top_level_name():
    mods = {"gridcodegenerator_tpu_torch.api": 1, "jaxtyping": 1,
            "flaxen": 1}
    assert runner.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "gridcodegenerator_tpu.ops": 1})
    assert runner.forbidden_modules(mods) == ["gridcodegenerator_tpu", "jax"]


def test_no_card_no_result(root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "iiwa14.fdgrad.b262144", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=root,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_raising_call_fails_the_run(root):
    calls = []

    def raises(model, *batch):
        calls.append(1)
        if len(calls) > 3:   # past the warm-up: the window's calls
            raise RuntimeError("planted")
        return port.forward_dynamics_gradient(model, *batch)
    r = _run(root, fn=raises)
    # the warm-up and the window's first two calls answered
    assert not r["correct"] and r["failed"] == r["attempted"] - 2 > 0


class Stale:
    """Every call returns the first call's answer: the state left as it
    was."""

    def __init__(self, fn):
        self.fn, self.first = fn, None

    def __call__(self, model, *batch):
        if self.first is None:
            self.first = self.fn(model, *batch)
        return self.first.clone()


def half_left_out(fn):
    """Half of the batch left out: its answers are the other half's."""
    def faulty(model, *batch):
        out = fn(model, *batch)
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out
    return faulty


def altered(fn):
    """An answer altered where it is produced: one entry of every state's
    answer moved by a tenth of the state's largest."""
    def faulty(model, *batch):
        out = fn(model, *batch)
        flat = out.reshape(out.shape[0], -1)
        flat[:, 1] += 0.1 * flat.abs().amax(dim=1)
        return out
    return faulty


def last_state_altered(fn):
    """A fault confined to the batch's end (as in its last, partial block):
    only the last state's answer is altered."""
    def faulty(model, *batch):
        out = fn(model, *batch)
        flat = out.reshape(out.shape[0], -1)
        flat[-1, 1] += 0.1 * flat[-1].abs().amax()
        return out
    return faulty


FAULTS = {"stale": Stale, "half_left_out": half_left_out,
          "altered": altered, "last_state_altered": last_state_altered}
CELLS = {"iiwa14.fdgrad.b262144": SMALL,
         "iiwa14.idgrad.b262144": SMALL,
         "iiwa14.hvp.b65536": {**SMALL, "batch": 8,
                               "sample": {"rows_per_call": 2,
                                          "max_states": 32}}}
# long enough for two calls of the plain version on one core
SECONDS = {"forward_dynamics_hessian_vp": 2.0}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(root, name, fault):
    cell = registry.cell(name, root)
    fn = FAULTS[fault](getattr(port, cell.entry))
    r = _run(root, name, fn=fn, seconds=SECONDS.get(cell.entry, 0.5),
             overrides=CELLS[name])
    # a stale answer shows from the second call on
    assert r["attempted"] >= (2 if fault == "stale" else 1)
    assert not r["correct"], r["checks"]
    assert r["checks"]["gap"]["value"] > r["checks"]["gap"]["limit"]


def test_a_nonfinite_answer_outside_the_kept_rows_fails_the_run(root):
    """One state's answer, in the batch's middle, is NaN on every call: the
    run counts each call as failed, kept rows or not."""
    def nan_inside(model, *batch):
        out = port.forward_dynamics_gradient(model, *batch)
        out[out.shape[0] // 2 + 1, 0, 0] = float("nan")
        return out
    r = _run(root, fn=nan_inside)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] > 0
    assert r["checks"]["failed_calls"]["value"] == r["failed"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(root, name):
    """The control, the reference in TF32 put in the program's place, runs
    through the harness and its check and comes out not correct, above the
    cell's limit; the program's float32 plain version, run alike, comes out
    correct (a small batch on the CPU)."""
    cell = registry.cell(name, root)
    limit = registry.limits(name, root)["numbers"]["gap"]["limit"]
    seconds = SECONDS.get(cell.entry, 0.5)
    r = _run(root, name, fn=harness.control(cell, torch.device("cpu")),
             seconds=seconds, overrides=CELLS[name])
    assert r["failed"] == 0 and not r["correct"], r["checks"]
    assert r["checks"]["gap"]["value"] > limit
    r = _run(root, name, seconds=seconds, overrides=CELLS[name])
    assert r["correct"] and r["checks"]["gap"]["value"] < limit
