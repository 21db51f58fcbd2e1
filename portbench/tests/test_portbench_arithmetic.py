"""The harness's arithmetic: the seeded pool, the rate over the whole window,
the 95th percentile over all calls, the device timeline from overlapping
intervals, and the per-layer readers."""

import statistics

import pytest
import torch

from portbench import harness, registry, trace

TRAFFIC = {"batch": 16, "pool_min_bytes": 4096,
           "inputs": [{"name": "q", "low": -2.0, "high": 2.0},
                      {"name": "qd", "low": -1.0, "high": 1.0},
                      {"name": "u", "low": -8.0, "high": 8.0}]}


def test_pool_repeats_from_its_seed():
    a = harness.Pool(TRAFFIC, 7, 2**31 + 5, torch.device("cpu"))
    b = harness.Pool(TRAFFIC, 7, 2**31 + 5, torch.device("cpu"))
    c = harness.Pool(TRAFFIC, 7, 2**31 + 6, torch.device("cpu"))
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    # enough batches for the minimum bytes, each input in its range
    assert a.nbytes >= TRAFFIC["pool_min_bytes"] and a.batches >= 2
    for i, s in enumerate(TRAFFIC["inputs"]):
        x = a.x[:, i]
        assert x.min() >= s["low"] and x.max() <= s["high"]
        assert x.max() - x.min() > 0.9 * (s["high"] - s["low"])
    # calls cycle through the batches; rows() gives the same states back
    q, qd, u = a.batch(a.batches + 1)
    assert q.shape == (16, 7) and torch.equal(q, a.x[1, 0])
    rows = a.rows(torch.tensor([1, 0]), torch.tensor([3, 5]))
    assert torch.equal(rows[2][0], a.x[1, 2, 3])
    assert torch.equal(rows[0][1], a.x[0, 0, 5])


def test_pool_holds_four_l2_of_states(root):
    l2 = registry.peaks("NVIDIA H100 80GB HBM3", root)["l2_bytes"]
    for name in ("fdgrad.b262144", "idgrad.b262144", "hvp.b65536"):
        assert registry.traffic(name, root)["pool_min_bytes"] >= 4 * l2


def test_p95_is_over_all_calls():
    times = [1.0] * 95 + [10.0] * 5
    assert harness.p95(times) == statistics.quantiles(
        times, n=20, method="inclusive")[18]
    assert harness.p95([1.0] * 99 + [50.0]) < 50.0
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.05)


def _fn_sleep(model, *batch):
    return torch.zeros(batch[0].shape[0], 2, 2)


def test_rate_is_over_the_whole_window():
    pool = harness.Pool(TRAFFIC, 7, 1, torch.device("cpu"))
    sampler = harness.Sampler(pool, 1)
    w = harness.run_window(_fn_sleep, None, pool, sampler, 0.2, "api.x",
                           torch.device("cpu"))
    assert w.calls == len(w.times) == len(sampler.kept) > 1
    assert sampler.nonfinite_calls() == 0
    assert w.seconds >= 0.2
    # the rate counts every call over the window, not the mean call time
    assert sum(w.times) <= w.seconds


def test_sampler_keeps_the_ends_and_counts_nonfinite_calls():
    """Each call keeps its first and last row beside the drawn ones, and a
    call whose answer is non-finite in a row that is not kept counts."""
    pool = harness.Pool(TRAFFIC, 7, 3, torch.device("cpu"))
    sampler = harness.Sampler(pool, 2)
    out = torch.arange(16.0).view(16, 1).repeat(1, 3)
    for call in range(3):
        sampler.take(call, out.clone())
    calls, rows, kept = sampler.gathered()
    assert kept.shape == (3 * 4, 3) and torch.equal(kept[:, 0], rows.float())
    assert rows.view(3, 4)[:, :2].tolist() == [[0, 15]] * 3
    assert sampler.nonfinite_calls() == 0
    kept_rows = set(rows.tolist())
    hidden = next(r for r in range(16) if r not in kept_rows)
    bad = out.clone()
    bad[hidden, 1] = float("nan")
    sampler.take(3, bad)
    bad[hidden, 1] = float("inf")
    sampler.take(4, bad)
    assert sampler.nonfinite_calls() == 2
    sampler.clear()
    assert sampler.nonfinite_calls() == 0 and sampler.gathered()[2] is None


def _events(kernels, spans, launches):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
           "dur": e - s} for n, s, e in spans]
    for i, (name, s, e) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": s,
                   "dur": e - s, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": launches[i], "dur": 1, "args": {"correlation": i}})
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "api.e",
               "ts": 0, "dur": 100})
    return ev


def test_timeline_from_overlapping_intervals():
    spans = [("pool", 0, 2), ("api.e", 2, 10), ("sync", 10, 60),
             ("sample", 60, 62), ("pool", 62, 64), ("api.e", 64, 70),
             ("sync", 70, 100)]
    kernels = [("grid_k", 10, 40), ("direct_copy_kernel_cuda", 30, 50),
               ("CatArrayBatchedCopy", 45, 55), ("index_select", 61, 63),
               ("grid_k", 75, 95)]
    launches = [3, 4, 5, 61, 65]
    tl = trace.timeline(_events(kernels, spans, launches), "api.e")
    assert tl.window_s == pytest.approx(100e-6)
    # union: [10, 55] ∪ [61, 63] ∪ [75, 95]
    assert tl.busy_s == pytest.approx(67e-6)
    assert tl.api_s == pytest.approx((30 + 20 + 10 + 20) * 1e-6)
    assert tl.boundary_s == pytest.approx(30e-6)
    assert tl.program_s == pytest.approx(50e-6)
    assert tl.ops["grid_k"] == pytest.approx(50e-6)
    gaps = dict(((round(s * 1e6), n) for n, s in tl.gaps))
    assert gaps == {10: "api.e", 6: "sync", 12: "api.e", 5: "sync"}
    bd = trace.breakdown(tl)
    assert bd["device_ops"][0] == ["grid_k", pytest.approx(50e-6)]
    assert bd["idle_gaps"][0][1] == pytest.approx(12e-6)


def _readings(metric, tl=None, calls=10):
    tl = tl or trace.Timeline(window_s=1.0, busy_s=0.9, api_s=0.5,
                              boundary_s=0.1)
    return harness.Readings(
        metric=metric, batch=1000, calls=calls,
        launches=40, timeline=tl,
        counts={"ops_per_state": 2.0e6, "bytes_per_state": 1000},
        peaks={"float32_flops": 1e12, "bytes_per_s": 1e12})


def test_readers(root):
    read = lambda m, **kw: registry.reader(m, root).read(_readings(m, **kw))
    assert read("launches_per_call") == 4.0
    assert read("boundary_ms") == pytest.approx(0.1 / 10 * 1e3)
    assert read("device_idle_pct") == pytest.approx(10.0)
    # bound 2e9 ops / 1e12 = 2 ms a call; the program's 40 ms a call
    assert read("fdgrad_roofline") == pytest.approx(5.0)
    # every entry's roofline is the one reader, on that cell's counts
    assert read("hvp_roofline") == pytest.approx(5.0)
    # no call or no trace: left out, never 0
    assert registry.reader("fdgrad_roofline", root).read(
        _readings("fdgrad_roofline", calls=0)) is None
    empty = _readings("device_idle_pct", tl=trace.Timeline())
    assert registry.reader("device_idle_pct", root).read(empty) is None
