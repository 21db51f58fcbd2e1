"""One run of a cell: set-up, the measured window, the check, the metrics.

The window is a closed loop with one caller: each call takes the next batch
of the seeded state pool, calls the program's public entry on it and waits
for the device (``torch.cuda.synchronize``), as a solver iteration waits for
its derivatives. Each call's first and last rows and a few drawn from the
seed are kept, and its whole answer is looked at for a NaN or an infinity;
once the window has closed the kept rows are held to the float64
reference, which works the robot and the states out again from the robot
file and the seed.
"""

from __future__ import annotations

import gc
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from . import registry, trace
from .reference import _rbd

GIB = float(1 << 30)
SAMPLE_CYCLE = 4096   # rows drawn ahead for the kept samples, reused cyclically
CONTROL_BLOCKS = 16   # the control answers a whole batch, 16 blocks at once


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Pool:
    """The window's states: batches of the traffic's inputs, uniform in their
    ranges, drawn on the device from the seed in one call. Together they
    hold at least the mix's ``pool_min_bytes``, more than the card's L2, so
    no call finds its inputs in the cache."""

    def __init__(self, traffic, n, seed, device, dtype=torch.float32):
        spec = traffic["inputs"]
        self.k, self.B, self.n = len(spec), int(traffic["batch"]), n
        per_batch = self.k * self.B * n * torch.finfo(dtype).bits // 8
        self.batches = max(2, math.ceil(traffic["pool_min_bytes"] / per_batch))
        self.nbytes = self.batches * per_batch
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        x = torch.rand((self.batches, self.k, self.B, n), generator=self.gen,
                       device=device, dtype=dtype)
        low = torch.tensor([s["low"] for s in spec], device=device,
                           dtype=dtype).view(1, self.k, 1, 1)
        width = torch.tensor([s["high"] - s["low"] for s in spec],
                             device=device, dtype=dtype).view(1, self.k, 1, 1)
        self.x = x.mul_(width).add_(low)

    def batch(self, call):
        """Call ``call``'s inputs, each (B, n), batch first."""
        return self.x[call % self.batches].unbind(0)

    def rows(self, calls, rows):
        """The inputs of rows ``rows`` (S,) of calls ``calls`` (S,), each
        (S, n)."""
        picked = self.x[calls % self.batches, :, rows]      # (S, k, n)
        return picked.unbind(1)


class Sampler:
    """Keeps rows of each call's answer, issued behind the call on the
    device: its first and last row and ``rows_per_call`` drawn from the
    pool's generator. Counts, on the device, the calls whose answer holds a
    non-finite value anywhere (the sum over the whole answer, which a NaN
    or an infinity makes non-finite; read once after the window)."""

    def __init__(self, pool, rows_per_call):
        dev = pool.x.device
        drawn = torch.randint(pool.B, (SAMPLE_CYCLE, rows_per_call),
                              generator=pool.gen, device=dev)
        ends = torch.tensor([0, pool.B - 1], device=dev).expand(
            SAMPLE_CYCLE, 2)
        self.idx = torch.cat([ends, drawn], dim=1)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.calls, self.kept = [], []

    def take(self, call, out):
        self.calls.append(call)
        self.kept.append(out.index_select(0, self.idx[call % SAMPLE_CYCLE]))
        self.bad += ~torch.isfinite(out.sum())

    def clear(self):
        self.calls.clear()
        self.kept.clear()
        self.bad.zero_()

    def nonfinite_calls(self):
        return int(self.bad)

    def gathered(self):
        """The call and row of each kept answer, and the answers,
        (calls·r, ...); None without a kept answer."""
        if not self.kept:
            return None, None, None
        r = self.idx.shape[1]
        call = torch.tensor(self.calls, device=self.idx.device)
        rows = self.idx[call % SAMPLE_CYCLE]
        return (call.repeat_interleave(r), rows.reshape(-1),
                torch.cat(self.kept))


@dataclass
class Window:
    calls: int = 0
    raised: int = 0
    errors: list = field(default_factory=list)
    times: list = field(default_factory=list)    # seconds, issue to sync
    seconds: float = 0.0      # window start to the end of its last call
    launches: int = 0         # the program's launch counter's rise
    mem_base: int = 0
    mem_peak: int = 0
    timeline: trace.Timeline | None = None


def _launch_count():
    from gridcodegenerator_tpu_torch.ops.kernels import _launch
    return sum(_launch.LAUNCHES.values())


def run_window(fn, model, pool, sampler, seconds, span, device):
    """Call ``fn(model, *batch)`` on consecutive pool batches until
    ``seconds`` have passed; each call ends in a device synchronisation.
    The harness's own work for a call (its kept rows, the count of
    non-finite answers, the next batch) is issued before that
    synchronisation, while the device still runs the
    call, so that it adds no host time between calls."""
    from torch.profiler import record_function
    w = Window()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        w.mem_base = torch.cuda.memory_allocated(device)
    launches0 = _launch_count()
    start = end = time.perf_counter()
    call = 0
    with record_function(trace.POOL):
        batch = pool.batch(call)
    while end - start < seconds:
        t0 = time.perf_counter()
        try:
            with record_function(span):
                out = fn(model, *batch)
        except (RuntimeError, ValueError) as e:
            # the answer never comes: counted as failed, and the run is not
            # correct
            w.raised += 1
            w.errors.append(f"call {call}: {type(e).__name__}: {e}")
            out = None
        answered = out is not None
        if answered:
            with record_function(trace.SAMPLE):
                sampler.take(call, out)
            del out
        call += 1
        with record_function(trace.POOL):
            batch = pool.batch(call)
        with record_function(trace.SYNC):
            sync(device)
        end = time.perf_counter()
        if answered:
            w.times.append(end - t0)
    w.calls = call
    w.seconds = end - start
    w.launches = _launch_count() - launches0
    if device.type == "cuda":
        w.mem_peak = torch.cuda.max_memory_allocated(device)
    return w


def p95(values):
    """The 95th percentile (Python's inclusive quantiles)."""
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def gaps(out, ref):
    """Each state's widest gap relative to its own scale:
    max|out − ref| / max|ref|, over the state's answer."""
    dims = tuple(range(1, ref.dim()))
    return ((out - ref).abs().amax(dim=dims)
            / ref.abs().amax(dim=dims).clamp_min(torch.finfo(ref.dtype).tiny))


def reference_answers(cell, inputs, device, tf32=False):
    """The reference's answers to ``inputs`` (each (S, n)), in blocks of its
    ``BLOCK`` states: float64, or the TF32 control."""
    mod = registry.reference(cell.entry, cell.root)
    dyn = _rbd.Dynamics(_rbd.read_urdf(cell.path(cell.config["robot"])),
                        device=device, tf32=tf32)
    x = [t.to(dyn.dtype) for t in inputs]
    return _rbd.in_blocks(lambda *b: mod.reference(dyn, *b), x, mod.BLOCK)


def _sample(n_rows, cap, seed):
    """Which of ``n_rows`` kept rows the check compares: all, or ``cap``
    of them drawn from the seed."""
    if n_rows <= cap:
        return torch.arange(n_rows)
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n_rows, generator=gen)[:cap].sort().values


def card_limit():
    """``name, power.limit`` of the card, as nvidia-smi gives it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def check(cell, traffic, sampler, n, seed, device):
    """Holds the kept answers to the reference: (the widest ``gap`` over
    the compared states, how many were compared, how many calls returned a
    non-finite value). The states are drawn again from the seed."""
    t0 = time.perf_counter()
    bad_calls = sampler.nonfinite_calls()
    calls, rows, kept = sampler.gathered()
    sampler.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if kept is None:
        return float("nan"), 0, bad_calls
    pick = _sample(kept.shape[0], traffic["sample"]["max_states"],
                   seed).to(device)
    pool = Pool(traffic, n, seed, device)   # the same states again
    inputs = pool.rows(calls[pick], rows[pick])
    del pool
    ref = reference_answers(cell, inputs, device)
    g = gaps(kept[pick].to(ref.dtype), ref)
    gap = float(g.max()) if bool(torch.isfinite(g).all()) else float("inf")
    log(f"check: {pick.numel()} states of {len(set(calls.tolist()))} calls "
        f"in {time.perf_counter() - t0:.1f} s")
    return gap, int(pick.numel()), bad_calls


def control(cell, device):
    """The control, put in the program's place: ``fn(model, *batch)`` that
    answers with the reference computed in TF32 (every matrix product on
    TF32-rounded operands, in float32), over the whole batch, in blocks of
    ``CONTROL_BLOCKS`` × the reference's own."""
    mod = registry.reference(cell.entry, cell.root)
    dyn = _rbd.Dynamics(_rbd.read_urdf(cell.path(cell.config["robot"])),
                        device=device, tf32=True)

    def fn(model, *batch):
        x = [t.to(dyn.dtype) for t in batch]
        out = _rbd.in_blocks(lambda *b: mod.reference(dyn, *b), x,
                             mod.BLOCK * CONTROL_BLOCKS)
        return out.to(batch[0].dtype)
    return fn


def control_overrides(traffic):
    """The mix's numbers for a run of the control: no warm-up (it builds
    nothing), and as many rows kept from each of its few, slow calls as a
    run of the program compares in all, so that the check compares as many
    states."""
    most = traffic["sample"]["max_states"]
    return {"warmup_calls": 0,
            "sample": {"rows_per_call": most, "max_states": most}}


def run(cell, seed, seconds, traced, *, device="cuda", t0=None, fn=None,
        overrides=None):
    """One run of ``cell``; returns the result line's object. ``fn``
    replaces the program's entry and ``overrides`` the mix's numbers: the
    tests use them to run small and to plant faults."""
    import gridcodegenerator_tpu_torch as port
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    traffic = {**cell.traffic, **(overrides or {})}
    model = port.load_robot(str(cell.path(cell.config["robot"])),
                            dtype=getattr(torch, cell.config["dtype"]),
                            device=device)
    fn = fn or getattr(port, cell.entry)
    pool = Pool(traffic, model.n, seed, device)
    sampler = Sampler(pool, traffic["sample"]["rows_per_call"])
    span = trace.api_span(cell.entry)
    # warm-up: the cell's own shapes (this builds or loads the kernels)
    for call in range(traffic.get("warmup_calls", 2)):
        sampler.take(0, fn(model, *pool.batch(call)))
    sync(device)
    sampler.clear()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        fn(model, *pool.batch(0))   # outside the window's spans
        sync(device)
    setup_s = time.perf_counter() - t0
    try:
        w = run_window(fn, model, pool, sampler, seconds, span, device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    log(f"window: {w.calls} calls in {w.seconds:.3f} s")
    if prof is not None:
        w.timeline = trace.timeline(trace.export_events(prof), span)
        del prof
    for e in w.errors[:5]:
        log(e)

    # the check, once the program's state is freed
    del pool
    gap, checked, bad_calls = check(cell, traffic, sampler, model.n, seed,
                                    device)
    failed = w.raised + bad_calls
    lim = registry.limits(cell.name, cell.root)["numbers"]
    checks = {"gap": {"value": gap, "limit": lim["gap"]["limit"]},
              "failed_calls": {"value": failed, "limit": 0}}
    correct = (w.calls > 0 and failed == 0 and checked > 0
               and gap <= lim["gap"]["limit"])

    result = {"correct": correct, "attempted": w.calls, "failed": failed}
    B = int(traffic["batch"])
    completed = w.calls - w.raised
    if not traced:
        values = {
            "evals_per_s": (B * completed / w.seconds, "evals/s"),
            "call_ms_p95": (p95(w.times) * 1e3, "ms"),
            "peak_mem_gib": ((w.mem_peak - w.mem_base) / GIB, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        metrics = {m["name"]: {"value": values[m["name"]][0],
                               "unit": m["unit"]} for m in cell.end_to_end}
    else:
        metrics = per_layer(cell, w, B)
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": w.mem_peak,
           "card_power_limit": card_limit() if device.type == "cuda"
           else "none"}
    if traced and w.timeline is not None:
        dev["busy_s"] = w.timeline.busy_s
        dev["window_s"] = w.timeline.window_s
        result["breakdown"] = trace.breakdown(w.timeline)
    result["device"] = dev
    result["checked_states"] = checked
    result["checks"] = checks
    return result


@dataclass
class Readings:
    """What a per-layer reader may read: the window's counts and timeline,
    the entry's frozen operation and byte counts, and the card's peaks."""

    metric: str
    batch: int
    calls: int
    launches: int
    timeline: trace.Timeline | None
    counts: dict
    peaks: dict


def per_layer(cell, w, B):
    """Each of the cell's per-layer metrics, read by its reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    kind = (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "cpu")
    try:
        peaks = registry.peaks(kind, cell.root)
    except KeyError:
        peaks = {}
    counts = registry.counts(cell.config_name, cell.entry, cell.root)
    out = {}
    for m in cell.per_layer:
        r = Readings(metric=m["name"], batch=B, calls=w.calls - w.raised,
                     launches=w.launches, timeline=w.timeline, counts=counts,
                     peaks=peaks)
        value = registry.reader(m["name"], cell.root).read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
