#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gridcodegenerator_tpu_torch/ops/
kernels/csrc`` and runs, on ``cuda:0``:

0. a toolchain probe: the card's name and power limit, torch and its CUDA,
   nvcc, whether triton imports; then the kernel builds (time and ptxas's
   register / spill report per kernel);
1. every kernel against its plain PyTorch version on iiwa-14 (a chain) and
   the branched arm (siblings under a moving parent), at B = 4096 and a
   ragged B = 1000, in float64 and float32;
2. the main path: ``forward_dynamics_gradient`` on iiwa-14, float32,
   B = 2¹⁸ through the public API (``impl="auto"``), its 256-state parity
   head against the float64 golden model (bench.py's protocol), and the
   other three API entries at the same B against their plain versions;
3. times: the median of CUDA-event-timed calls of each kernel and of its
   plain version at the main path's shape.

Imports no jax. Fails (non-zero exit, no result line) when there is no CUDA
device or any check fails. The second-to-last line is the kernels' JSON
record; the last is ``{"ok": true, "device": {...}}``.
"""

import json
import re
import shutil
import subprocess
import time

import numpy as np
import torch

import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu_torch.models import zoo
from gridcodegenerator_tpu_torch.ops.kernels import _build, fused

SEED = 0
MAIN_B = 1 << 18
PARITY_STATES = 256      # bench.py's parity head
COMPARE_STATES = 4096    # main-path kernel-vs-plain comparison
PARITY_MAX = 5e-6        # f32 vs float64 golden, max over the head
# Kernel vs plain, as max|k − p| / max(1, max|p|) over each output tensor.
# float64: the same sums in the same order (FMA contraction aside), so the
# kernel must match its plain version to round-off. float32: both versions
# are held to the plain version run in float64 on the same inputs; the
# kernel's error must stay under 1e-5 or under twice the plain float32
# version's own error. A few ulps in X(q) move an ill-conditioned state's
# gradient by ~1e-5 in either version, so no float32 code meets a bare 1e-5
# on thousands of random states.
REL_TOL = {torch.float64: 1e-11, torch.float32: 1e-5}
F32_PLAIN_FACTOR = 2.0
TIMED_CALLS = 10

SOURCE = "gridcodegenerator_tpu_torch/ops/kernels/csrc/fused.cu"
KERNELS = {  # LAUNCHES key → TPU kernel it replaces
    "fd_grad": "gridcodegenerator_tpu/ops/kernels/fused.py:394",
    "id_grad": "gridcodegenerator_tpu/ops/kernels/fused.py:433",
    "minv": "gridcodegenerator_tpu/ops/kernels/fused.py:290",
    "inverse_dynamics": "gridcodegenerator_tpu/ops/kernels/fused.py:270",
}
ROBOTS = {"iiwa14": zoo.iiwa14(), "branched_arm": zoo.branched_arm()}


def log(*a):
    print(*a, flush=True)


def card():
    """``name, power.limit`` as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def uniform_states(n, B, dtype, gen, layout="nB"):
    """q ∈ [−2, 2], q̇ ∈ [−1, 1], u ∈ [−8, 8] (bench.py's ranges)."""
    shape = (n, B) if layout == "nB" else (B, n)
    out = []
    for r in (2.0, 1.0, 8.0):
        x = torch.rand(shape, generator=gen, device="cuda", dtype=dtype)
        out.append(x * (2 * r) - r)
    return out


def _bias_kernel(m, q, qd):
    return fused.inverse_dynamics_fused(m, q, qd, None)


def _bias_plain(m, q, qd):
    return fused.inverse_dynamics_plain(m, q, qd, None)


# name → (LAUNCHES key, kernel wrapper, plain version, number of (n, B)
# state inputs); bias_force is the qdd=None variant of the RNEA kernel
PAIRS = {
    "fd_grad": ("fd_grad", fused.fd_grad_fused, fused.fd_grad_plain, 3),
    "id_grad": ("id_grad", fused.id_grad_fused, fused.id_grad_plain, 3),
    "minv": ("minv", fused.minv_fused, fused.minv_plain, 1),
    "inverse_dynamics": ("inverse_dynamics", fused.inverse_dynamics_fused,
                         fused.inverse_dynamics_plain, 3),
    "bias_force": ("inverse_dynamics", _bias_kernel, _bias_plain, 2),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare(got, ref):
    """(normwise relative error, worst per-state relative error, max abs
    error) of kernel outputs against plain outputs, batch last."""
    rel = st = ab = 0.0
    for k, p in zip(_as_tuple(got), _as_tuple(ref)):
        diff = (k.double() - p.double()).abs()
        pa = p.double().abs()
        ab = max(ab, float(diff.max()))
        rel = max(rel, float(diff.max() / pa.max().clamp(min=1.0)))
        d_state = diff.reshape(-1, diff.shape[-1]).amax(0)
        p_state = pa.reshape(-1, pa.shape[-1]).amax(0).clamp(min=1.0)
        st = max(st, float((d_state / p_state).max()))
    return rel, st, ab


def check_finite(name, outs):
    for o in _as_tuple(outs):
        if not bool(torch.isfinite(o).all()):
            raise RuntimeError(f"{name}: non-finite output")


# ---------------------------------------------------------------- phase 0
def phase0_toolchain():
    log(f"card: {card()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc}: {ver[-1]}")
    try:
        import triton  # noqa: F401
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    log(f"ninja: {shutil.which('ninja')}")


_PTXAS_NAME = re.compile(r"(fd_grad|id_grad|minv|rnea)_kernelI([fd])(Lb([01])E)?")


def ptxas_report(log_text):
    """One line per kernel: registers, stack frame and spills."""
    lines, name, frame = [], None, ""
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            m = _PTXAS_NAME.search(ln)
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                    f"{'' if m.group(3) is None else ', qdd=' + m.group(4)}>"
                    if m else ln.split("'")[1])
        elif "stack frame" in ln and name:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"  {name}: {ln.split(':', 1)[1].strip()}; {frame}")
            name = None
    return lines


def build_all(models):
    for label, m in models.items():
        t0 = time.perf_counter()
        lib = _build.library(m)
        log(f"build {label} (n={m.n}): {time.perf_counter() - t0:.1f} s "
            f"(nvcc {lib.build_seconds:.1f} s) -> "
            f"{lib.path.relative_to(_build.BUILD_DIR.parents[1])}")
        for line in ptxas_report(lib.log):
            log(line)


# ---------------------------------------------------------------- phase 1
def check_against_plain(tag, got, plain, m, args):
    """Hold a kernel's output to its plain version on the same inputs: in
    float64 directly; in float32 against the plain version run in float64
    on the same (upcast) inputs, beside the plain float32 version's own
    error against that reference. Returns the max abs error."""
    if m.dtype == torch.float64:
        ref = plain(m, *args)
        tol = REL_TOL[m.dtype]
        extra = ""
    else:
        ref = plain(m.to(dtype=torch.float64), *(x.double() for x in args))
        p_rel, p_st, _ = compare(plain(m, *args), ref)
        k_rel, k_st, _ = compare(got, plain(m, *args))
        tol = max(REL_TOL[m.dtype], F32_PLAIN_FACTOR * p_rel)
        extra = (f"; plain f32 vs f64 plain: rel {p_rel:.3e} (per-state "
                 f"{p_st:.3e}); kernel vs plain f32: rel {k_rel:.3e} "
                 f"(per-state {k_st:.3e})")
    rel, st, ab = compare(got, ref)
    ok = rel <= tol
    log(f"{tag}: rel {rel:.3e} (per-state {st:.3e}, abs {ab:.3e}) tol "
        f"{tol:.1e} {'ok' if ok else 'FAIL'}{extra}")
    if not ok:
        raise RuntimeError(f"{tag}: kernel disagrees with its plain version")
    return ab


def phase1_kernels_vs_plain(gen):
    for label, urdf in ROBOTS.items():
        for dtype in (torch.float64, torch.float32):
            m = gt.load_robot(urdf, dtype=dtype, device="cuda")
            for B in (4096, 1000):
                q, qd, u = uniform_states(m.n, B, dtype, gen)
                for name, (key, kern, plain, k) in PAIRS.items():
                    args = (q, qd, u)[:k]
                    before = fused.LAUNCHES[key]
                    got = kern(m, *args)
                    torch.cuda.synchronize()
                    if fused.LAUNCHES[key] != before + 1:
                        raise RuntimeError(f"{name}: kernel not launched")
                    check_finite(name, got)
                    check_against_plain(
                        f"phase1 {label} {str(dtype)[6:]} B={B} {name}",
                        got, plain, m, args)


# ---------------------------------------------------------------- phase 2
def phase2_main_path(gen):
    desc = gt.parse_urdf(ROBOTS["iiwa14"])
    m = gt.robot_model_from_description(desc, dtype=torch.float32,
                                        device="cuda")
    n = m.n
    q, qd, u = uniform_states(n, MAIN_B, torch.float32, gen, layout="Bn")
    fused.reset_launches()
    t0 = time.perf_counter()
    J = gt.forward_dynamics_gradient(m, q, qd, u)
    c = gt.inverse_dynamics(m, q, qd, u)
    bias = gt.bias_force(m, q, qd)
    Minv = gt.direct_minv(m, q)
    G = gt.inverse_dynamics_gradient(m, q, qd, u)
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    log(f"phase2 main path B={MAIN_B} (five API calls, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}")
    for name, cnt in launches.items():
        if cnt < 1:
            raise RuntimeError(f"main path never launched {name}")
    if J.device.type != "cuda" or tuple(J.shape) != (MAIN_B, n, 2 * n):
        raise RuntimeError(f"∇FD output {J.device} {tuple(J.shape)}")
    for name, out in (("fd_grad", J), ("inverse_dynamics", c),
                      ("bias_force", bias), ("minv", Minv),
                      ("id_grad", G)):
        check_finite(name, out)

    # parity head vs the float64 golden model (bench.py's protocol)
    gold = gt.GoldenDynamics(desc)
    head = J[:PARITY_STATES].double().cpu().numpy()
    hq, hqd, hu = (x[:PARITY_STATES].double().cpu().numpy()
                   for x in (q, qd, u))
    errs = np.empty(PARITY_STATES)
    for k in range(PARITY_STATES):
        ref = gold.fd_grad(hq[k], hqd[k], hu[k])
        errs[k] = np.abs(head[k] - ref).max() / max(1.0, np.abs(ref).max())
    parity = {"max": float(errs.max()),
              "p99": float(np.quantile(errs, 0.99)),
              "median": float(np.median(errs)), "states": PARITY_STATES}
    log(f"phase2 f32-vs-golden relative parity ({PARITY_STATES} states): "
        f"max={parity['max']:.3e} p99={parity['p99']:.3e} "
        f"median={parity['median']:.3e} (bound {PARITY_MAX:.0e})")
    if parity["max"] > PARITY_MAX:
        raise RuntimeError("∇FD f32 parity head above its bound")

    # each API entry's output (kernel, batch first) against its plain
    # version (batch last) on the head states
    s = COMPARE_STATES
    cols = [x[:s].T.contiguous() for x in (q, qd, u)]
    api_out = {"fd_grad": J, "inverse_dynamics": c, "bias_force": bias,
               "minv": Minv, "id_grad": G}
    max_abs = {}
    for name, out in api_out.items():
        _, _, plain, k = PAIRS[name]
        if name in ("fd_grad", "id_grad"):   # the API's [∂/∂q | ∂/∂q̇]
            plain = (lambda f: lambda *a: torch.cat(f(*a), 1))(plain)
        max_abs[name] = check_against_plain(
            f"phase2 {name} API vs plain ({s} states)",
            out[:s].movedim(0, -1), plain, m, cols[:k])
    return m, launches, max_abs, parity


# ---------------------------------------------------------------- phase 3
def time_ms(fn, args, calls=TIMED_CALLS, warmup=2):
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase3_times(m, gen):
    name_limit = card()
    q, qd, u = uniform_states(m.n, MAIN_B, torch.float32, gen)
    times = {}
    for name in KERNELS:
        _, kern, plain, k = PAIRS[name]
        args = (m, q, qd, u)[:k + 1]
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = time_ms(plain, args)
        k1 = time_ms(kern, args)
        k2 = time_ms(kern, args)
        p2 = time_ms(plain, args)
        times[name] = (min(k1, k2), min(p1, p2))
        log(f"phase3 {name} iiwa14 f32 B={MAIN_B}: kernel {k1:.3f}/{k2:.3f} "
            f"ms, plain {p1:.3f}/{p2:.3f} ms (median of {TIMED_CALLS}); "
            f"kernel {MAIN_B / min(k1, k2) * 1e3:.3e} evals/s; "
            f"card {name_limit}")
    qb, qdb, ub = (x.T.contiguous() for x in (q, qd, u))
    api = time_ms(gt.forward_dynamics_gradient, (m, qb, qdb, ub))
    log(f"phase3 forward_dynamics_gradient API (B, n) -> (B, n, 2n), "
        f"B={MAIN_B}: {api:.3f} ms ({MAIN_B / api * 1e3:.3e} evals/s); "
        f"card {name_limit}")
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    phase0_toolchain()
    build_all({label: gt.load_robot(u, device="cuda")
               for label, u in ROBOTS.items()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    phase1_kernels_vs_plain(gen)
    m, launches, max_abs, parity = phase2_main_path(gen)
    times = phase3_times(m, gen)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": tpu,
         "launches": launches[name], "max_abs_err": max_abs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, tpu in KERNELS.items()]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
