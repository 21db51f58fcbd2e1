#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gridcodegenerator_tpu_torch/ops/
kernels/csrc`` and runs, on ``cuda:0``:

0. a toolchain probe: the card's name and power limit, torch and its CUDA,
   nvcc, whether triton imports; then the kernel builds of iiwa-14, the
   branched arm, Atlas, HyQ and a 16-joint tree, all at once (nvcc
   seconds and ptxas's register / stack frame / spill report per kernel);
1. every kernel against its plain PyTorch version at B = 4096 and a ragged
   B = 1000, in float64 and float32: the single-kernel families on iiwa-14
   (a chain) and the branched arm (siblings under a moving parent); ABA on
   both and on Atlas; the staged kernels (K1, K2′ with and without a
   right-hand side, K4, the ∂ID vaf sweep, K5 with and without the finish)
   on Atlas (n = 28, a forest) and forced on the branched arm at a column
   block that leaves a ragged last block;
2. path iiwa-14: ``forward_dynamics_gradient`` and the three prefix
   families, float32, B = 2¹⁸ through the public API, its 256-state parity
   head against the float64 golden model (bench.py's protocol), each output
   against its plain version; path B: ``forward_dynamics`` (ABA) on iiwa-14
   at B = 2¹⁸;
A. path A, Atlas at B = 2¹⁸, float32: ``forward_dynamics_gradient``
   through the staged pipeline, then ``inverse_dynamics_gradient``,
   ``direct_minv``, ``inverse_dynamics``, ``bias_force`` and
   ``forward_dynamics``; launch counts, the 256-state ∇FD parity head beside
   the plain float32 version's head, each output and each stage kernel
   against its plain version;
3. times: the median of CUDA-event-timed calls of each kernel and of its
   plain version at its path's shape, the API times, and a profiler
   breakdown of the Atlas ∇FD call; each kernel's bound (the larger of its
   operations over the card's float32 rate and its bytes over its memory
   rate; operations as :class:`OpCount` counts them); ∇FD of HyQ (n = 12)
   and a 16-joint tree on both routes, the single-thread kernel and the
   staged pipeline, each held to its plain version first.

Each path runs with every launch count set to 0 just before it and read
just after. Imports no jax. Fails (non-zero exit, no result line) when
there is no CUDA device or any check fails. The second-to-last line is the
kernels' JSON record; the last is ``{"ok": true, "device": {...}}``.
"""

import json
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import gridcodegenerator_tpu_torch as gt
from gridcodegenerator_tpu_torch.models import zoo
from gridcodegenerator_tpu_torch.ops.kernels import (_build, _launch, fused,
                                                    staged)

SEED = 0
MAIN_B = 1 << 18
PARITY_STATES = 256      # bench.py's parity head
COMPARE_STATES = 4096    # main-path kernel-vs-plain comparison
PARITY_MAX = 5e-6        # iiwa-14 f32 vs float64 golden, max over the head
# Atlas's head is held to the plain float32 version's on the same states:
# M(q) is worse conditioned at n = 28 than the 5e-6 bound assumes
ATLAS_HEAD_FACTOR = 2.0
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
PLAIN_BUDGET_MS = 3000.0   # fewer timed calls for plain versions above it
# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores,
# and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FUSED_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/fused.cu"
STAGED_SRC = "gridcodegenerator_tpu_torch/ops/kernels/csrc/staged.cu"
TPU = "gridcodegenerator_tpu/ops/kernels/"
ROBOTS = {"iiwa14": zoo.iiwa14(), "branched_arm": zoo.branched_arm(),
          "atlas": zoo.atlas()}
FORCED_CB = 4   # the branched arm (n = 9) through K5: blocks of 4, 4 and 1
# robots at and under MAX_KERNEL_JOINTS whose ∇FD is timed on both routes:
# a forest of four 3-joint legs, and a seeded 16-joint forest of three
# trees, one a 10-joint chain (a 16-joint serial chain's M(q) is too
# ill-conditioned for the float64 check's 1e-11)
ROUTE_ROBOTS = {"hyq": zoo.hyq(), "tree16": zoo.random_tree(16, seed=0)}


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
ABA = ("aba", fused.forward_dynamics_aba_fused,
       fused.forward_dynamics_aba_plain, 3)


def staged_pairs(cb=None):
    """The staged kernels as (LAUNCHES key, kernel, plain, inputs): each
    stage's inputs are (q, q̇, u) and the plain upstream stages' outputs,
    so every kernel is held to its plain version on identical inputs."""
    def up(m, q, qd, u):
        c, v = staged.bias_and_v_plain(m, q, qd)
        Minv, qdd = staged.minv_qdd_dense_plain(m, q, u - c)
        a, f = staged.af_plain(m, q, qd, qdd, v)
        v2, a2, f2 = staged.vaf_plain(m, q, qd, u)
        return dict(c=c, v=v, Minv=Minv, qdd=qdd, a=a, f=f, v2=v2, a2=a2,
                    f2=f2)

    return up, {
        "bias_and_v": ("bias_and_v", staged.bias_and_v_staged,
                       staged.bias_and_v_plain, lambda s, x: (s[0], s[1])),
        "minv_dense": ("minv_dense", staged.minv_qdd_dense_staged,
                       staged.minv_qdd_dense_plain,
                       lambda s, x: (s[0], s[2] - x["c"])),
        "minv_dense_norhs": ("minv_dense", staged.minv_qdd_dense_staged,
                             staged.minv_qdd_dense_plain,
                             lambda s, x: (s[0],)),
        "af": ("af", staged.af_staged, staged.af_plain,
               lambda s, x: (s[0], s[1], x["qdd"], x["v"])),
        "vaf": ("vaf", staged.vaf_staged, staged.vaf_plain,
                lambda s, x: (s[0], s[1], s[2])),
        "grad_cols_finish": (
            "grad_cols_finish",
            lambda m, *a: staged.grad_cols_staged(m, *a[:5], cb=cb,
                                                  Minv=a[5]),
            lambda m, *a: staged.grad_cols_plain(m, *a[:5], cb=cb,
                                                 Minv=a[5]),
            lambda s, x: (s[0], s[1], x["v"], x["a"], x["f"], x["Minv"])),
        "grad_cols": (
            "grad_cols",
            lambda m, *a: staged.grad_cols_staged(m, *a, cb=cb),
            lambda m, *a: staged.grad_cols_plain(m, *a, cb=cb),
            lambda s, x: (s[0], s[1], x["v2"], x["a2"], x["f2"])),
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


def expect_launch(key, before, name):
    if _launch.LAUNCHES[key] != before + 1:
        raise RuntimeError(f"{name}: kernel not launched")


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


_PTXAS_NAME = re.compile(
    r"(fd_grad|id_grad|minv_dense|minv|rnea|aba|vaf|grad_cols)_kernelI([fd])"
    r"(?:L([bi])(\d+)E)?")
_TEMPLATE_ARG = {"rnea": "qdd", "minv_dense": "rhs", "vaf": "mode",
                 "grad_cols": "finish"}


def ptxas_report(log_text):
    """One line per kernel: registers, stack frame and spills."""
    lines, name, frame = [], None, ""
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            m = _PTXAS_NAME.search(ln)
            if m:
                arg = ("" if m.group(4) is None else
                       f", {_TEMPLATE_ARG.get(m.group(1), 't')}="
                       f"{m.group(4)}")
                name = (f"{m.group(1)}<"
                        f"{'float' if m.group(2) == 'f' else 'double'}{arg}>")
            else:
                name = ln.split("'")[1]
        elif "stack frame" in ln and name:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"  {name}: {ln.split(':', 1)[1].strip()}; {frame}")
            name = None
    return lines


def build_all(models):
    """Build every topology at once (one nvcc per source and topology)."""
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_build.library, args=(m,))
               for m in models.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log(f"builds of {len(models)} topologies: "
        f"{time.perf_counter() - t0:.1f} s wall")
    for label, m in models.items():
        lib = _build.library(m)     # raises here if its build failed
        for unit in lib.paths:
            log(f"build {label} (n={m.n}) {unit}: nvcc "
                f"{lib.build_seconds[unit]:.1f} s -> "
                f"{lib.paths[unit].relative_to(_build.BUILD_DIR.parents[1])}"
                f" (K5 column block {_build.default_col_block(m.n)})")
            for line in ptxas_report(lib.logs[unit]):
                log(line)


# ---------------------------------------------------------------- phase 1
def check_against_plain(tag, got, plain, m, args):
    """Hold a kernel's output to its plain version on the same inputs: in
    float64 directly; in float32 against the plain version run in float64
    on the same (upcast) inputs, beside the plain float32 version's own
    error against that reference. Returns (max abs error, normwise
    relative error)."""
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
    return ab, rel


def phase1_kernels_vs_plain(gen):
    for label in ROBOTS:
        for dtype in (torch.float64, torch.float32):
            m = gt.load_robot(ROBOTS[label], dtype=dtype, device="cuda")
            for B in (4096, 1000):
                q, qd, u = uniform_states(m.n, B, dtype, gen)
                # past MAX_KERNEL_JOINTS, ∇FD, ∂ID and M⁻¹ are the staged
                # kernels checked below; RNEA and ABA run on one thread
                pairs = {k: v for k, v in PAIRS.items()
                         if _build.dense_grads(m.n)
                         or k in ("inverse_dynamics", "bias_force")}
                pairs["aba"] = ABA
                for name, (key, kern, plain, k) in pairs.items():
                    args = (q, qd, u)[:k]
                    before = _launch.LAUNCHES[key]
                    got = kern(m, *args)
                    torch.cuda.synchronize()
                    expect_launch(key, before, name)
                    check_finite(name, got)
                    check_against_plain(
                        f"phase1 {label} {str(dtype)[6:]} B={B} {name}",
                        got, plain, m, args)
                if label == "iiwa14":
                    continue
                cb = FORCED_CB if label == "branched_arm" else None
                up, spairs = staged_pairs(cb)
                x = up(m, q, qd, u)
                for name, (key, kern, plain, inputs) in spairs.items():
                    args = inputs((q, qd, u), x)
                    before = _launch.LAUNCHES[key]
                    got = kern(m, *args)
                    torch.cuda.synchronize()
                    expect_launch(key, before, name)
                    check_finite(name, got)
                    check_against_plain(
                        f"phase1 {label} {str(dtype)[6:]} B={B} staged "
                        f"{name}{'' if cb is None else f' cb={cb}'}",
                        got, plain, m, args)


# ---------------------------------------------------------------- phase 2
def parity_head(desc, J, q, qd, u, label):
    """bench.py's protocol: per state max|J − J_golden| / max(1,
    max|J_golden|) against the float64 golden model."""
    gold = gt.GoldenDynamics(desc)
    head = J[:PARITY_STATES].double().cpu().numpy()
    hq, hqd, hu = (x[:PARITY_STATES].double().cpu().numpy()
                   for x in (q, qd, u))
    errs = np.empty(PARITY_STATES)
    for k in range(PARITY_STATES):
        ref = gold.fd_grad(hq[k], hqd[k], hu[k])
        errs[k] = np.abs(head[k] - ref).max() / max(1.0, np.abs(ref).max())
    out = {"max": float(errs.max()), "p99": float(np.quantile(errs, 0.99)),
           "median": float(np.median(errs)), "states": PARITY_STATES}
    log(f"{label} f32-vs-golden relative parity ({PARITY_STATES} states): "
        f"max={out['max']:.3e} p99={out['p99']:.3e} "
        f"median={out['median']:.3e}")
    return out


def api_vs_plain(tag, outs, plains, m, states):
    """Each API output (batch first) against its plain version (batch
    last) on the first COMPARE_STATES states."""
    s = COMPARE_STATES
    cols = [x[:s].T.contiguous() for x in states]
    max_abs = {}
    for name, out in outs.items():
        plain, k = plains[name]
        max_abs[name], _ = check_against_plain(
            f"{tag} {name} API vs plain ({s} states)",
            out[:s].movedim(0, -1), plain, m, cols[:k])
    return max_abs


def _cat_sides(f):
    return lambda *a, **kw: torch.cat(f(*a, **kw), 1)  # [∂/∂q | ∂/∂q̇]


def phase2_main_path(gen):
    desc = gt.parse_urdf(ROBOTS["iiwa14"])
    m = gt.robot_model_from_description(desc, dtype=torch.float32,
                                        device="cuda")
    n = m.n
    q, qd, u = uniform_states(n, MAIN_B, torch.float32, gen, layout="Bn")
    _launch.reset_launches()
    t0 = time.perf_counter()
    J = gt.forward_dynamics_gradient(m, q, qd, u)
    c = gt.inverse_dynamics(m, q, qd, u)
    bias = gt.bias_force(m, q, qd)
    Minv = gt.direct_minv(m, q)
    G = gt.inverse_dynamics_gradient(m, q, qd, u)
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    log(f"phase2 main path B={MAIN_B} (five API calls, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}")
    for name in ("fd_grad", "id_grad", "minv", "inverse_dynamics"):
        if launches[name] < 1:
            raise RuntimeError(f"main path never launched {name}")
    if J.device.type != "cuda" or tuple(J.shape) != (MAIN_B, n, 2 * n):
        raise RuntimeError(f"∇FD output {J.device} {tuple(J.shape)}")
    outs = {"fd_grad": J, "inverse_dynamics": c, "bias_force": bias,
            "minv": Minv, "id_grad": G}
    for name, out in outs.items():
        check_finite(name, out)
    parity = parity_head(desc, J, q, qd, u, "phase2")
    if parity["max"] > PARITY_MAX:
        raise RuntimeError(f"∇FD f32 parity head above {PARITY_MAX:.0e}")
    plains = {name: (_cat_sides(p) if name in ("fd_grad", "id_grad") else p,
                     k) for name, (_, _, p, k) in PAIRS.items()}
    max_abs = api_vs_plain("phase2", outs, plains, m, (q, qd, u))

    # path B: forward_dynamics (ABA) on iiwa-14
    _launch.reset_launches()
    qdd = gt.forward_dynamics(m, q, qd, u)
    torch.cuda.synchronize()
    b_launches = dict(_launch.LAUNCHES)
    log(f"phase2 path B forward_dynamics B={MAIN_B}: launches {b_launches}")
    if b_launches["aba"] < 1:
        raise RuntimeError("path B never launched aba")
    check_finite("forward_dynamics", qdd)
    max_abs.update(api_vs_plain("phase2 path B", {"aba": qdd},
                                {"aba": (ABA[2], 3)}, m, (q, qd, u)))
    launches["aba"] = b_launches["aba"]
    return m, launches, max_abs, parity


# ---------------------------------------------------------------- phase A
def phaseA_atlas(gen):
    desc = gt.parse_urdf(ROBOTS["atlas"])
    m = gt.robot_model_from_description(desc, dtype=torch.float32,
                                        device="cuda")
    n = m.n
    q, qd, u = uniform_states(n, MAIN_B, torch.float32, gen, layout="Bn")
    _launch.reset_launches()
    t0 = time.perf_counter()
    outs = {
        "fd_grad": gt.forward_dynamics_gradient(m, q, qd, u),
        "id_grad": gt.inverse_dynamics_gradient(m, q, qd, u),
        "minv": gt.direct_minv(m, q),
        "inverse_dynamics": gt.inverse_dynamics(m, q, qd, u),
        "bias_force": gt.bias_force(m, q, qd),
        "aba": gt.forward_dynamics(m, q, qd, u),
    }
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    log(f"phaseA Atlas (n={n}) path B={MAIN_B} (six API calls, first run): "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    for name in ("bias_and_v", "minv_dense", "af", "grad_cols_finish", "vaf",
                 "grad_cols", "aba", "inverse_dynamics"):
        if launches[name] < 1:
            raise RuntimeError(f"Atlas path never launched {name}")
    for name in ("fd_grad", "id_grad", "minv"):
        if launches[name] != 0:
            raise RuntimeError(f"Atlas path launched the single-thread "
                               f"{name} kernel")
    J = outs["fd_grad"]
    if J.device.type != "cuda" or tuple(J.shape) != (MAIN_B, n, 2 * n):
        raise RuntimeError(f"Atlas ∇FD output {J.device} {tuple(J.shape)}")
    for name, out in outs.items():
        check_finite(name, out)

    # the 256-state head against the golden model, beside the plain f32
    # version's head on the same states
    parity = parity_head(desc, J, q, qd, u, "phaseA kernel")
    cols = [x[:PARITY_STATES].T.contiguous() for x in (q, qd, u)]
    Jp = torch.cat(staged.fd_grad_plain(m, *cols), 1).movedim(-1, 0)
    plain_parity = parity_head(desc, Jp, q, qd, u, "phaseA plain")
    bound = ATLAS_HEAD_FACTOR * plain_parity["max"]
    log(f"phaseA head: kernel max {parity['max']:.3e} vs bound "
        f"{bound:.3e} (= {ATLAS_HEAD_FACTOR} × plain f32 max) "
        f"{'ok' if parity['max'] <= bound else 'FAIL'}")
    if parity["max"] > bound:
        raise RuntimeError("Atlas ∇FD f32 head above twice the plain one")

    plains = {
        "fd_grad": (_cat_sides(staged.fd_grad_plain), 3),
        "id_grad": (_cat_sides(staged.id_grad_plain), 3),
        "minv": (lambda mm, qq: staged.minv_qdd_dense_plain(mm, qq)[0], 1),
        "inverse_dynamics": (fused.inverse_dynamics_plain, 3),
        "bias_force": (_bias_plain, 2),
        "aba": (fused.forward_dynamics_aba_plain, 3),
    }
    max_abs = {f"{k}[atlas]": v for k, v in api_vs_plain(
        "phaseA", outs, plains, m, (q, qd, u)).items()}
    # each stage kernel on the head states, against its plain version
    s = [x[:COMPARE_STATES].T.contiguous() for x in (q, qd, u)]
    up, spairs = staged_pairs()
    x = up(m, *s)
    for name, (key, kern, plain, inputs) in spairs.items():
        args = inputs(s, x)
        max_abs[name], _ = check_against_plain(
            f"phaseA stage {name} ({COMPARE_STATES} states)",
            kern(m, *args), plain, m, args)
    return m, (q, qd, u), launches, max_abs, parity, plain_parity


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


def time_plain_ms(fn, args):
    """A plain version's time: fewer timed calls when one call is long."""
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    calls = int(min(TIMED_CALLS, max(3, PLAIN_BUDGET_MS // max(first, 1e-3))))
    return time_ms(fn, args, calls=calls, warmup=1), calls


class OpCount(TorchDispatchMode):
    """Counts the arithmetic a plain version's function needs, element by
    element of each output. An add, sub, mul or div counts only where every
    operand is neither 0 nor (for a factor or divisor) ±1: a term that is a
    structural zero — of the robot's constants, of a ∂-column outside a
    joint's root path, the 0 Python's ``sum`` starts from, or a 0/1 mask
    and the blends made with it — is one a code specialised on the topology
    skips. sqrt, reciprocal, sin and cos count every element; a negation is
    free (a sign flip folds into the operation that uses it), and so are
    copies, selects and stacks. An FMA is two."""

    _BINARY = {"add", "sub", "rsub", "mul", "div"}
    _UNARY = {"reciprocal", "sqrt", "sin", "cos"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    @staticmethod
    def _live(x, unit):
        """Where ``x`` is a real term: nonzero, and not ±1 if ``unit``."""
        live = x != 0
        if unit:
            live = live & (x != 1) & (x != -1)
        return live if isinstance(live, torch.Tensor) else torch.tensor(live)

    def _needed(self, name, args):
        a, b = args[0], args[1]
        if name == "div":          # a / b: free where a = 0 or b = ±1
            terms = [self._live(a, False), self._live(b, True)]
        elif name == "mul":        # free where a factor is 0 or ±1
            terms = [self._live(a, True), self._live(b, True)]
        else:                      # a ± b: free where either is 0
            terms = [self._live(a, False), self._live(b, False)]
        shape = torch.broadcast_shapes(*(t.shape for t in terms))
        return int((terms[0] & terms[1]).expand(shape).sum())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self._BINARY:
            self.ops += self._needed(name, args)   # before an in-place op
        out = func(*args, **(kwargs or {}))
        if name in self._UNARY:
            self.ops += out.numel()
        return out


def ops_per_state(plain, m, make_args):
    """Operations a state: the count at B = 2 less the count at B = 1 (the
    constant-only work drops out), on CPU tensors of random states."""
    mc = m.to(device="cpu", dtype=torch.float64)
    counts = []
    for B in (1, 2):
        args = make_args(mc, B)
        with OpCount() as c:
            plain(mc, *args)
        counts.append(c.ops)
    return counts[1] - counts[0]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(ops, bytes_):
    """(bound ms, what sets it): the larger of the operations over the
    float32 rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cpu_states(k, extra=None):
    """make_args for ops_per_state: k random (n, B) states in bench.py's
    ranges, from SEED [+ the staged inputs built from them]."""
    def make(mc, B):
        gen = torch.Generator().manual_seed(SEED)
        st = [(torch.rand((mc.n, B), generator=gen, dtype=torch.float64)
               * 2 - 1) * r for r in (2.0, 1.0, 8.0)[:k]]
        return st if extra is None else extra(mc, B, st)
    return make


def _staged_cpu_args(name):
    def extra(mc, B, st):
        up, spairs = staged_pairs()
        return spairs[name][3](st, up(mc, *st))
    return _cpu_states(3, extra)


def time_entry(label, name, kern, plain, m, args, make_cpu_args, name_limit):
    """Time a kernel and its plain version (plain, kernel, kernel, plain in
    one call), and its bound at these inputs."""
    p1, n1 = time_plain_ms(plain, (m, *args))
    k1 = time_ms(kern, (m, *args))
    k2 = time_ms(kern, (m, *args))
    p2, n2 = time_plain_ms(plain, (m, *args))
    outs = _as_tuple(kern(m, *args))
    ops = ops_per_state(plain, m, make_cpu_args) * args[0].shape[-1]
    b_ms, b_by = bound(ops, nbytes(*args, *outs))
    k, p = min(k1, k2), min(p1, p2)
    log(f"phase3 {name} {label} f32 B={args[0].shape[-1]}: kernel "
        f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms (median of "
        f"{TIMED_CALLS} / {n1},{n2}); bound {b_ms:.3f} ms by {b_by} "
        f"({ops:.3e} ops, {nbytes(*args, *outs):.3e} B; roofline share "
        f"{b_ms / k:.1%}); card {name_limit}")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by)


def profile_breakdown(fn, args, label, name_limit, calls=3):
    """Device time by kernel over ``calls`` calls (torch.profiler), and the
    busy share of the window."""
    fn(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(calls):
            fn(*args)
        b.record()
        b.synchronize()
    window = a.elapsed_time(b)
    # device kernels only: an aten op's row repeats its kernels' time
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and (getattr(e, "device_type", None) == DeviceType.CUDA
                        or not e.key.startswith(("aten::", "cuda"))):
            rows.append((e.key, dev / 1e3, e.count))
    busy = sum(r[1] for r in rows)
    if not rows:
        log(f"phase3 profile {label}: no device time in the trace (not "
            f"measured)")
        return
    log(f"phase3 profile {label} ({calls} calls, window {window:.3f} ms, "
        f"device busy {busy:.3f} ms = {busy / window:.1%}; card "
        f"{name_limit}):")
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms / calls:9.3f} ms/call {ms / busy:6.1%} x{cnt // calls} "
            f"{key[:100]}")


def phase3_times(m, mA, atlas_states, gen):
    name_limit = card()
    times = {}
    q, qd, u = uniform_states(m.n, MAIN_B, torch.float32, gen)
    for name in ("fd_grad", "id_grad", "minv", "inverse_dynamics"):
        _, kern, plain, k = PAIRS[name]
        times[name] = time_entry("iiwa14", name, kern, plain, m,
                                 (q, qd, u)[:k], _cpu_states(k), name_limit)
    times["aba"] = time_entry("iiwa14", "aba", ABA[1], ABA[2], m, (q, qd, u),
                              _cpu_states(3), name_limit)
    qb, qdb, ub = (x.T.contiguous() for x in (q, qd, u))
    for fn in (gt.forward_dynamics_gradient, gt.forward_dynamics):
        api = time_ms(fn, (m, qb, qdb, ub))
        log(f"phase3 {fn.__name__} API iiwa14 B={MAIN_B}: {api:.3f} ms "
            f"({MAIN_B / api * 1e3:.3e} evals/s); card {name_limit}")

    # Atlas: every stage kernel at its main-path shape, on the path's own
    # intermediates
    s = [x.T.contiguous() for x in atlas_states]
    for name in ("inverse_dynamics", "aba"):
        pair = ABA if name == "aba" else PAIRS[name]
        times[f"{name}[atlas]"] = time_entry(
            "atlas", name, pair[1], pair[2], mA, tuple(s[:pair[3]]),
            _cpu_states(pair[3]), name_limit)
    _, spairs = staged_pairs()
    x = {}
    x["c"], x["v"] = staged.bias_and_v_staged(mA, s[0], s[1])
    x["Minv"], x["qdd"] = staged.minv_qdd_dense_staged(mA, s[0],
                                                       s[2] - x["c"])
    x["a"], x["f"] = staged.af_staged(mA, s[0], s[1], x["qdd"], x["v"])
    x["v2"], x["a2"], x["f2"] = staged.vaf_staged(mA, *s)
    for name, (_, kern, plain, inputs) in spairs.items():
        times[name] = time_entry("atlas", name, kern, plain, mA,
                                 tuple(inputs(s, x)), _staged_cpu_args(name),
                                 name_limit)
    del x
    qa, qda, ua = atlas_states
    for fn in (gt.forward_dynamics_gradient, gt.inverse_dynamics_gradient,
               gt.direct_minv, gt.forward_dynamics):
        k = 1 if fn is gt.direct_minv else 3
        api = time_ms(fn, (mA, qa, qda, ua)[:k + 1])
        log(f"phase3 {fn.__name__} API atlas B={MAIN_B}: {api:.3f} ms "
            f"({MAIN_B / api * 1e3:.3e} evals/s); card {name_limit}")
    profile_breakdown(gt.forward_dynamics_gradient, (mA, qa, qda, ua),
                      "forward_dynamics_gradient atlas", name_limit)
    return times


def phase3_routes(gen):
    """∇FD of robots at and under MAX_KERNEL_JOINTS on both routes — the
    single-thread kernel and the staged pipeline — each held to its plain
    version, then timed single, staged, staged, single: where the routes
    cross over."""
    name_limit = card()
    for label, urdf in ROUTE_ROBOTS.items():
        m = gt.load_robot(urdf, dtype=torch.float32, device="cuda")
        q, qd, u = uniform_states(m.n, MAIN_B, torch.float32, gen)
        # checked in float64: the float32 rule's plain error is itself
        # conditioning at these depths
        m64 = m.to(dtype=torch.float64)
        s = [x[:, :COMPARE_STATES].double().contiguous() for x in (q, qd, u)]
        routes = {"single": (fused.fd_grad_fused, fused.fd_grad_plain),
                  "staged": (staged.fd_grad_staged, staged.fd_grad_plain)}
        for route, (kern, plain) in routes.items():
            check_against_plain(
                f"phase3 routes {label} (n={m.n}) {route} ∇FD f64 "
                f"({COMPARE_STATES} states)", kern(m64, *s), plain, m64, s)
        ms = {r: [] for r in routes}
        for r in ("single", "staged", "staged", "single"):
            ms[r].append(time_ms(routes[r][0], (m, q, qd, u)))
        log(f"phase3 routes {label} (n={m.n}, K5 cb "
            f"{_build.default_col_block(m.n)}) ∇FD f32 B={MAIN_B}: "
            + "; ".join(f"{r} {a:.3f}/{b:.3f} ms" for r, (a, b) in ms.items())
            + f"; card {name_limit}")
        del q, qd, u


# (JSON name, LAUNCHES key, path, source, TPU kernel it replaces)
RECORD = [
    ("fd_grad", "fd_grad", "iiwa14", FUSED_SRC, TPU + "fused.py:394"),
    ("id_grad", "id_grad", "iiwa14", FUSED_SRC, TPU + "fused.py:433"),
    ("minv", "minv", "iiwa14", FUSED_SRC, TPU + "fused.py:290"),
    ("inverse_dynamics", "inverse_dynamics", "iiwa14", FUSED_SRC,
     TPU + "fused.py:270"),
    ("aba", "aba", "iiwa14", FUSED_SRC, TPU + "fused.py:357"),
    ("inverse_dynamics[atlas]", "inverse_dynamics", "atlas", FUSED_SRC,
     TPU + "fused.py:270"),
    ("aba[atlas]", "aba", "atlas", FUSED_SRC, TPU + "fused.py:357"),
    ("bias_and_v", "bias_and_v", "atlas", STAGED_SRC, TPU + "staged.py:172"),
    ("minv_dense", "minv_dense", "atlas", STAGED_SRC, TPU + "staged.py:218"),
    ("af", "af", "atlas", STAGED_SRC, TPU + "staged.py:453"),
    ("grad_cols_finish", "grad_cols_finish", "atlas", STAGED_SRC,
     TPU + "staged.py:470"),
    ("vaf", "vaf", "atlas", STAGED_SRC, TPU + "staged.py:341"),
    ("grad_cols", "grad_cols", "atlas", STAGED_SRC, TPU + "staged.py:356"),
]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    phase0_toolchain()
    build_all({label: gt.load_robot(u, device="cuda")
               for label, u in {**ROBOTS, **ROUTE_ROBOTS}.items()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    phase1_kernels_vs_plain(gen)
    m, launches, max_abs, parity = phase2_main_path(gen)
    mA, atlas_states, a_launches, a_max_abs, a_parity, a_plain = \
        phaseA_atlas(gen)
    max_abs.update(a_max_abs)
    times = phase3_times(m, mA, atlas_states, gen)
    phase3_routes(gen)
    path_launches = {"iiwa14": launches, "atlas": a_launches}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": path_launches[path][key], "max_abs_err": max_abs[name],
         **times[name], "library_ms": None}
        for name, key, path, src, tpu in RECORD]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
