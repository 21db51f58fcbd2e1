"""Counts the work of one call of an entry, a state at a time, once.

    python3 portbench/counts/count.py            # print the counts
    python3 portbench/counts/count.py --write    # and freeze them here

For each (configuration, entry) pair of ``BENCHMARK.json``'s cells it
writes ``counts/<config>.<entry>.json``: the operations and bytes a state
that the per-layer rooflines read. A run of the benchmark
counts nothing: it reads these files.

The operations are those the program's plain version needs, counted by a
``TorchDispatchMode`` while the public entry runs on float64 CPU tensors
(where the program runs its plain PyTorch batch-last version): an add,
sub, mul or div counts only where no operand is a structural zero (nor, for
a factor or divisor, ±1), sqrt, reciprocal, sin and cos count every
element, copies and matrix products through ``einsum`` count nothing — a
lower bound of the work. Per state: the count at B = 2 less the count at
B = 1. For λᵀ·H's staged pipeline, each tangent stage runs its primal once
for each of its n directions; the least work runs it once a state, so
(n − 1) primal counts of each tangent stage call are taken off. The bytes
read each input once and write each output once, in the configuration's
dtype. Runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[2]


class OpCount(TorchDispatchMode):
    """Counts the arithmetic a plain version's function needs, element by
    element of each output. An add, sub, mul or div counts only where every
    operand is neither 0 nor (for a factor or divisor) ±1: a term that is a
    structural zero — of the robot's constants, of a ∂-column outside a
    joint's root path, the 0 Python's ``sum`` starts from, or a 0/1 mask
    and the blends made with it — is one a code specialised on the topology
    skips. sqrt, reciprocal, sin and cos count every element; a negation is
    free (a sign flip folds into the operation that uses it), and so are
    copies, selects and stacks. An FMA is two. Under forward-mode AD the
    tangent arithmetic runs as aten operations too and is counted alike, a
    zero tangent's terms skipped."""

    _BINARY = {"add", "sub", "rsub", "mul", "div"}
    _UNARY = {"reciprocal", "sqrt", "sin", "cos"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    @staticmethod
    def _mask(x, unit):
        live = x != 0
        return live & (x != 1) & (x != -1) if unit else live

    @staticmethod
    def _live_number(x, unit):
        return x != 0 and not (unit and x in (1, -1))

    def _needed(self, name, args):
        a, b = args[0], args[1]
        unit_a, unit_b = name == "mul", name in ("mul", "div")
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if not (ta and tb):
            (x, ux), (n, un) = (((a, unit_a), (b, unit_b)) if ta
                                else ((b, unit_b), (a, unit_a)))
            if not self._live_number(n, un):
                return 0
            if not isinstance(x, torch.Tensor):
                return int(self._live_number(x, ux))
            return int(self._mask(x, ux).sum()) if ux else int(
                torch.count_nonzero(x))
        return int((self._mask(a, unit_a) & self._mask(b, unit_b)).sum())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta"
               for a in args):
            return func(*args, **(kwargs or {}))
        if name in self._BINARY:
            self.ops += self._needed(name, args)
        out = func(*args, **(kwargs or {}))
        if name in self._UNARY:
            self.ops += out.numel()
        return out


def ops_per_state(fn, make_args):
    """Operations a state: the count at B = 2 less the count at B = 1 (the
    constant-only work drops out)."""
    counts = []
    for B in (1, 2):
        args = make_args(B)
        with OpCount() as c:
            fn(*args)
        counts.append(c.ops)
    return counts[1] - counts[0]


def _states(n, inputs, B, seed=0):
    """Random (B, n) float64 inputs in the mix's ranges."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand((B, n), generator=gen, dtype=torch.float64)
            * (s["high"] - s["low"]) + s["low"] for s in inputs]


def _hvp_primal_repeats(m, inputs):
    """λᵀ·H's staged pipeline: the (n − 1) repeats of each tangent stage's
    primal a state (``so_staged._vp_pipeline``: T1, T4 on q and on q̇; T2;
    T5 on (q, q), (q, q̇), (q̇, q̇))."""
    from gridcodegenerator_tpu_torch.ops import blops
    from gridcodegenerator_tpu_torch.ops.kernels import so_staged, staged
    from gridcodegenerator_tpu_torch.ops.kernels._build import \
        dense_hessian_vp
    if dense_hessian_vp(m.n):
        raise NotImplementedError(
            "the single-thread λᵀ·H route's count is not written")

    def upstream(B):
        """The pipeline's primal intermediates (batch last), as the stages
        receive them."""
        q, qd, u, lam = (x.T.contiguous() for x in _states(m.n, inputs, B))
        c, v = staged.bias_and_v_plain(m, q, qd)
        Minv, qdd = staged.minv_qdd_dense_plain(m, q, u - c)
        a, f = staged.af_plain(m, q, qd, qdd, v)
        lamM = torch.einsum("ijb,jb->ib", Minv, lam).contiguous()
        return dict(q=q, qd=qd, v=v, a=a, f=f, qdd=qdd, lamM=lamM)

    def t5_primal(side):
        cb = so_staged._so_col_block(m, None)

        def primal(x):
            X = blops.joint_transforms_bl(m, x["q"])
            vl, al, fl = (staged._as_list(x[k], m.n) for k in "vaf")
            for c0, w in staged._blocks(m.n, cb):
                rows = blops.rnea_grad_cols_bl(
                    m, X, x["qd"], vl, al, fl, c0=c0, cb=w, sides=(side,),
                    as_rows=True)[side]
                sum(x["lamM"][i:i + 1] * r for i, r in enumerate(rows)
                    if r is not None)
        return primal

    primals = {
        "t1": lambda x: staged.bias_and_v_plain(m, x["q"], x["qd"]),
        "t2": lambda x: so_staged.crba_matvecs(
            m, blops.joint_transforms_bl(m, x["q"]), (x["lamM"], x["qdd"])),
        "t4": lambda x: staged.af_plain(m, x["q"], x["qd"], x["qdd"],
                                        x["v"]),
        "t5_q": t5_primal("q"),
        "t5_qd": t5_primal("qd"),
    }
    calls = {"t1": 2, "t2": 1, "t4": 2, "t5_q": 1, "t5_qd": 2}
    once = {k: ops_per_state(fn, lambda B: (upstream(B),))
            for k, fn in primals.items()}
    return (m.n - 1) * sum(calls[k] * once[k] for k in calls), once


def count(config_name, traffic_name, root=ROOT):
    """The frozen count of one (configuration, mix) pair."""
    import gridcodegenerator_tpu_torch as port
    from portbench import registry
    cfg = registry.config(config_name, root)
    mix = registry.traffic(traffic_name, root)
    entry, inputs = mix["entry"], mix["inputs"]
    t0 = time.perf_counter()
    m = port.load_robot(str(root / cfg["robot"]),
                        dtype=getattr(torch, cfg["dtype"]), device="cpu")
    m64 = m.to(device="cpu", dtype=torch.float64)
    fn = getattr(port, entry)
    total = ops_per_state(lambda *a: fn(m64, *a),
                          lambda B: _states(m.n, inputs, B))
    out_shape = fn(m64, *_states(m.n, inputs, 1)).shape[1:]
    itemsize = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    doc = {"config": config_name, "entry": entry, "joints": m.n,
           "ops_plain_per_state": total}
    how = ("OpCount (portbench/counts/count.py, a copy of chip_smoke.py's) "
           f"of gridcodegenerator_tpu_torch.{entry} on float64 CPU tensors "
           "(the program's plain version), count at B = 2 less at B = 1")
    if entry == "forward_dynamics_hessian_vp":
        repeats, once = _hvp_primal_repeats(m64, inputs)
        doc["primal_repeats_per_state"] = repeats
        doc["tangent_stage_primals_once"] = once
        how += ("; less (n − 1) × each tangent stage call's primal (T1 ×2, "
                "T2, T4 ×2, T5 on (q, q), (q, q̇), (q̇, q̇))")
    else:
        repeats = 0
    doc["ops_per_state"] = total - repeats
    doc["bytes_per_state"] = itemsize * (len(inputs) * m.n
                                         + int(torch.tensor(out_shape).prod()))
    doc["bytes_how"] = (f"each of the {len(inputs)} (n,) inputs read once and "
                        f"the {tuple(out_shape)} output written once, "
                        f"{cfg['dtype']}")
    doc["how"] = how
    doc["torch"] = torch.__version__
    doc["seconds"] = round(time.perf_counter() - t0, 1)
    return doc


def pairs(root=ROOT):
    """Each (configuration, mix) pair of the benchmark's cells, once per
    (configuration, entry)."""
    from portbench import registry
    seen, out = set(), []
    for w in registry.benchmark(root)["workloads"]:
        entry = registry.traffic(w["traffic"], root)["entry"]
        if (w["config"], entry) not in seen:
            seen.add((w["config"], entry))
            out.append((w["config"], w["traffic"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="freeze the counts as counts/<config>.<entry>.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    for cfg, mix in pairs():
        doc = count(cfg, mix)
        print(json.dumps(doc), flush=True)
        if args.write:
            path = Path(__file__).parent / f"{cfg}.{doc['entry']}.json"
            path.write_text(json.dumps(doc, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
