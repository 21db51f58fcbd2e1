"""The benchmark of ``gridcodegenerator_tpu_torch``, one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card. Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (and
``breakdown`` when traced), and last ``checks``, each number compared
beside its limit; the same numbers close standard error. Exits non-zero,
with no result, without a CUDA card, where the program is missing, or if
the process loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# what a run may not load: JAX and the JAX package, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "gridcodegenerator_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules}
                  & set(FORBIDDEN))


def _caches():
    """Kernel caches at fixed paths inside the checkout: the program's nvcc
    output goes to ``build/torch_kernels`` by itself; any Triton or
    extension build goes beside it."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness, registry

    cell = registry.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        harness.log(f"{cell.name} needs {cell.chips} CUDA card(s); this "
                    f"machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import gridcodegenerator_tpu_torch as port
    if ROOT not in Path(port.__file__).resolve().parents:
        harness.log(f"the program was imported from {port.__file__}, not "
                    f"from this checkout")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         t0=T0)
    found = forbidden_modules()
    if found:
        harness.log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
