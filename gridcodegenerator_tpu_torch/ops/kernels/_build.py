"""Build the CUDA kernels of ``csrc/`` for one robot topology, at first use.

One shared library per topology: ``nvcc`` compiles ``csrc/fused.cu`` for
``sm_90a`` with the joint count, parent indices and joint types passed as
``-D`` macros (``csrc/rbd.cuh``), so every joint loop unrolls. The library
has a plain C interface and is loaded with ``ctypes``; it lands in
``build/torch_kernels/`` at the repository root, keyed by the topology and a
hash of the sources, beside a ``.log`` holding nvcc's and ptxas's output
(registers, spills and local memory per kernel). A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("rbd.cuh", "fused.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_SIGNATURES = {
    # consts, q, qd, u, ddq, ddqd, B, gravity, stream
    "grid_fd_grad": (_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                     ctypes.c_double, _P),
    # consts, q, qd, qdd, dq, dqd, B, gravity, stream
    "grid_id_grad": (_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                     ctypes.c_double, _P),
    # consts, q, M, B, stream
    "grid_minv": (_P, _P, _P, ctypes.c_longlong, _P),
    # consts, q, qd, qdd (or NULL), c, B, gravity, stream
    "grid_rnea": (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_double,
                  _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    """A loaded per-topology kernel library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was reused
    log: str               # nvcc/ptxas output of the build

    def entry(self, name: str, dtype_tag: str):
        return getattr(self.lib, f"{name}_{dtype_tag}")

    def error_string(self, code: int) -> str:
        return self.lib.grid_error_string(code).decode()


_LOCK = threading.Lock()
_LOADED: dict[tuple, KernelLibrary] = {}


def topology_key(model) -> tuple:
    """What a kernel library is specialised on: joint count, parents and
    which joints are prismatic."""
    return (model.n, tuple(model.topology.parents),
            tuple(int(t == "prismatic") for t in model.joint_types))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def _digest(key: tuple) -> str:
    h = hashlib.sha256(repr(key).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(key: tuple, out: Path) -> tuple[float, str]:
    n, parents, prism = key
    # build under a private name, then rename: concurrent builds never
    # load a half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-O3", "-std=c++17", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        f"-DGRID_N={n}",
        # nvcc splits -D values at commas: lists go as G(a)G(b)...
        "-DGRID_PARENTS=" + "".join(f"G({p})" for p in parents),
        "-DGRID_PRISMATIC=" + "".join(f"G({p})" for p in prism),
        "-o", str(tmp), str(_CSRC / "fused.cu"),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {out.name}:\n"
            f"{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return seconds, log


def library(model) -> KernelLibrary:
    """The kernel library for ``model``'s topology, built if needed."""
    key = topology_key(model)
    with _LOCK:
        if key in _LOADED:
            return _LOADED[key]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"grid_n{key[0]}_{_digest(key)}.so"
        if so.exists():
            seconds, log = 0.0, so.with_suffix(".log").read_text()
        else:
            seconds, log = _compile(key, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            for tag in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{tag}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.grid_num_joints.argtypes = ()
        lib.grid_num_joints.restype = ctypes.c_int
        lib.grid_error_string.argtypes = (ctypes.c_int,)
        lib.grid_error_string.restype = ctypes.c_char_p
        if lib.grid_num_joints() != key[0]:
            raise RuntimeError(f"{so} was built for "
                               f"{lib.grid_num_joints()} joints, not {key[0]}")
        _LOADED[key] = KernelLibrary(lib, so, seconds, log)
        return _LOADED[key]
