"""The host side of the CTA tiles (``csrc/tile.cuh``): the topology tables
and tile sizes ``ops/kernels/_build.py`` passes to the build
(``grad_cols_tile_plan``, ``minv_tile_plan`` for K5 and K2′;
``rnea_tile_plan`` for the sweeps K1, K4 and ∂ID's vaf; ``fd_tile_plan``
for the recursion ∇FD), on the prismatic chain, the branched arm, HyQ,
Atlas and a seeded 16-joint tree (and iiwa-14 for the sweeps and the ∇FD):

* the packed columns cover every entry the plain K5 (``grad_cols_plain``,
  both sides, float64) gives nonzero on random states;
* the forward items are each (joint, column) pair once, in BFS waves after
  their parent's item; the backward items each (parent, column) once, after
  every child's; the finish's column lists are the nonzero rows, ascending;
  K2′'s sweep waves hold their children deepest first;
* at Atlas the tile sizes to the reference's packed ∂ID, 66n + 6·(4·130 +
  2·232) = 7,752 values a state, less the 18n of X's zero and repeated
  3×3 blocks (X is kept as E and B): 7,248; K2′ to 2,296;
* every plan fits one CTA's 227 KB in float32 and float64;
* the sweeps' forward waves hold every joint once, after its parent; the
  backward waves every parent once, after its children, each gathering
  its children in descending order (the plain version's order); the ∇FD
  tile's region B holds the M⁻¹ recursion's scratch and K5's ∂-tensors,
  and K5's packed columns cover every nonzero of ``fd_grad_plain``'s ∂ID
  (``id_grad_plain`` at the ∇FD's q̈) on random float64 states; both plans
  fit an SM's shared memory TILE_CTAS times.

The kernels themselves need a card; ``chip_smoke.py`` holds them to their
plain versions there. These checks are exact (integer tables), the
sparsity check exact zeros of the plain version.
"""

import functools

import pytest
import torch

import gridcodegenerator_tpu_torch as gt
from conftest import ROBOTS
from gridcodegenerator_tpu_torch.models import zoo
from gridcodegenerator_tpu_torch.ops.kernels import _build, _launch
from gridcodegenerator_tpu_torch.ops.kernels import fused as tf
from gridcodegenerator_tpu_torch.ops.kernels import staged as ts

torch.set_num_threads(1)

TILE_ROBOTS = {
    "iiwa14": ROBOTS["iiwa14"],
    "chain5p": ROBOTS["chain5p"],
    "barm": ROBOTS["barm"],
    "hyq": ROBOTS["hyq"],
    "atlas": ROBOTS["atlas"],
    "tree16": zoo.random_tree(16, seed=3),
}
B = 3


@functools.cache
def _model(name):
    return gt.load_robot(TILE_ROBOTS[name], dtype=torch.float64, device="cpu")


def _plans(m):
    parents = list(m.topology.parents)
    prism = [int(t == "prismatic") for t in m.joint_types]
    return (_build.grad_cols_tile_plan(parents, prism),
            _build.minv_tile_plan(parents, prism))


def _depth(parents):
    out = []
    for p in parents:
        out.append(0 if p < 0 else out[p] + 1)
    return out


@pytest.mark.parametrize("name", [k for k in TILE_ROBOTS if k != "iiwa14"])
def test_tile_plan(name):
    m = _model(name)
    n, parents = m.n, list(m.topology.parents)
    k5, k2 = _plans(m)
    dva, df = _build.k5_pattern(parents)
    depth = _depth(parents)
    assert k5["dva"] == sum(map(len, dva)) and k5["df"] == sum(map(len, df))

    # the packed ∂f columns hold every nonzero of the plain K5's rows
    g = torch.Generator().manual_seed(7)
    q, qd, qdd = ((torch.rand(n, B, generator=g, dtype=torch.float64) * 2
                   - 1) * r for r in (2.0, 1.0, 8.0))
    v, a, f = ts.vaf_plain(m, q, qd, qdd)
    for dc in ts.grad_cols_plain(m, q, qd, v, a, f):
        nz = (dc != 0).any(-1)
        for i in range(n):
            cols = {k for k in range(n) if nz[i, k]}
            assert cols <= set(df[i]), (i, sorted(cols - set(df[i])))

    t = k5["tables"]
    # forward items: each (i, k ∈ dva(i)) once, wave = depth(i), the
    # parent's slot of column k (−1 at the diagonal)
    fw = [tuple(t["fw"][5 * e:5 * e + 5]) for e in range(k5["dva"])]
    assert sorted((i, k) for i, k, *_ in fw) == sorted(
        (i, k) for i in range(n) for k in dva[i])
    assert sorted(d for *_, d, _, _ in fw) == list(range(k5["dva"]))
    by_slot = {dst: (i, k) for i, k, dst, _, _ in fw}
    waves = t["fw_waves"]
    for w in range(k5["waves"]):
        for i, k, dst, src, dfd in fw[waves[w]:waves[w + 1]]:
            assert depth[i] == w
            assert (src < 0) == (k == i)
            if src >= 0:
                assert by_slot[src] == (parents[i], k)
            assert t["df_ik"][2 * dfd:2 * dfd + 2] == [i, k]
            assert t["df_slot"][i * n + k] == dfd
    # backward items: each (p, k ∈ df(p)) of a parent once, deepest first
    bw = [tuple(t["bw"][4 * e:4 * e + 4]) for e in range(len(t["bw"]) // 4)]
    has_ch = [p for p in range(n) if p in parents]
    assert sorted((p, k) for p, k, _, _ in bw) == sorted(
        (p, k) for p in has_ch for k in df[p])
    done = set()
    for w in range(len(t["bw_waves"]) - 1):
        items = bw[t["bw_waves"][w]:t["bw_waves"][w + 1]]
        for p, k, dst, own in items:
            assert all(c in done or c not in has_ch for c in range(n)
                       if parents[c] == p)
            assert t["df_slot"][p * n + k] == dst
            assert own == (k in dva[p])
        done |= {p for p, *_ in items}
    # the finish: column c's rows, ascending, and their ∂f slots
    for c in range(n):
        j0, j1 = t["col_start"][c], t["col_start"][c + 1]
        rows = t["col_i"][j0:j1]
        assert rows == [i for i in range(n) if c in df[i]]
        assert t["col_d"][j0:j1] == [t["df_slot"][i * n + c] for i in rows]
    # K2′'s sweep: the waves' children deepest first, then their parents
    t2 = k2["tables"]
    seen = []
    for w in range(k2["waves"]):
        cs = t2["c"][t2["cw"][w]:t2["cw"][w + 1]]
        assert len({depth[c] for c in cs}) == 1 and all(
            depth[c] == max(depth) - w for c in cs)
        assert [t2["pos"][c] for c in cs] == list(range(len(cs)))
        assert t2["p"][t2["pw"][w]:t2["pw"][w + 1]] == sorted(
            {parents[c] for c in cs})
        seen += cs
    assert sorted(seen) == [i for i in range(n) if parents[i] >= 0]

    # every plan fits one CTA's shared memory, in f32 and in f64
    for plan in (k5, k2):
        for dt, size in (("f32", 4), ("f64", 8)):
            assert 1 <= plan["states"][dt] <= _build.TILE_MAX_STATES
            assert _build.tile_smem_bytes(plan, n, size) <= _build.SMEM_BYTES
    if name == "atlas":
        assert (k5["dva"], k5["df"]) == (130, 232)
        assert k5["values"] + 18 * n == 66 * n + 6 * (4 * 130 + 2 * 232) \
            == 7752
        assert k2["values"] == 18 * n + 36 * n + n * n == 2296
        assert (k5["states"], k2["states"]) == ({"f32": 7, "f64": 3},
                                                {"f32": 23, "f64": 10})


def test_tile_macros_and_design():
    """The build passes each plan as -D lists; K2′ and K5 launch the tiles
    unless DESIGN says "thread" (their one-thread kernels, counted apart)."""
    m = _model("barm")
    macros = _build._macros(_build.topology_key(m))
    for tag in ("K5", "K2"):
        assert sum(x.startswith(f"-DGRID_{tag}_") for x in macros) == 3
    k5, _ = _plans(m)
    offs = [x for x in macros if x.startswith("-DGRID_K5_OFFS=")][0]
    assert offs == "-DGRID_K5_OFFS=" + "".join(
        f"G({k5['offs'][k]})" for k in k5["tables"])
    assert _launch.design("minv_dense") == ("minv_dense", "grid_minv_dense")
    try:
        _launch.DESIGN = "thread"
        assert _launch.design("grad_cols_finish", "grid_grad_cols") == (
            "grad_cols_finish_thread", "grid_grad_cols_thread")
        _launch.DESIGN = "warp"
        with pytest.raises(ValueError, match="DESIGN"):
            _launch.design("minv_dense")
    finally:
        _launch.DESIGN = "tile"
    assert {f"{k}_thread" for k in ("minv_dense", "grad_cols_finish")} <= \
        set(_launch.LAUNCHES)
    for entry in ("grid_minv_dense_thread", "grid_grad_cols_thread"):
        assert _build.unit_of(entry) == "staged.cu"


def _sweep_plans(m):
    parents = list(m.topology.parents)
    prism = [int(t == "prismatic") for t in m.joint_types]
    return (_build.rnea_tile_plan(parents, prism),
            _build.fd_tile_plan(parents, prism))


@pytest.mark.parametrize("name", list(TILE_ROBOTS))
def test_sweep_and_fd_plans(name):
    m = _model(name)
    n, parents = m.n, list(m.topology.parents)
    rn, fd = _sweep_plans(m)
    depth = _depth(parents)
    t = rn["tables"]
    assert rn["waves"] == max(depth) + 1
    # forward: every joint once, wave = depth, so after its parent
    fw = t["fw"]
    assert sorted(fw) == list(range(n))
    for w in range(rn["waves"]):
        assert all(depth[i] == w for i in fw[t["fw_waves"][w]:
                                             t["fw_waves"][w + 1]])
    # backward: every parent once, deepest first; its children in
    # descending order, each one's own children gathered in an earlier wave
    has_ch = sorted({p for p in parents if p >= 0})
    assert sorted(t["bw"]) == has_ch
    done = set()
    for w in range(rn["waves"] - 1):
        wave = t["bw"][t["bw_waves"][w]:t["bw_waves"][w + 1]]
        for p in wave:
            ch = t["ch_list"][t["ch_start"][p]:t["ch_start"][p + 1]]
            assert ch == sorted((c for c in range(n) if parents[c] == p),
                                reverse=True)
            assert all(c in done or c not in has_ch for c in ch)
        done |= set(wave)
    assert t["par"] == parents
    # the ∇FD tile: region B holds the M⁻¹ recursion's scratch (IA, F, U,
    # D⁻¹, Ia·X, Xᵀ·U) and K5's ∂-tensors; then M⁻¹, q̇, u, q̈, ∂a seeds
    k5 = _build.grad_cols_tile_plan(parents,
                                    [int(x == "prismatic")
                                     for x in m.joint_types])
    assert fd["region_b"] >= max(85 * n + 6 * n * n,
                                 k5["values"] - k5["region"])
    assert fd["values"] == k5["region"] + fd["region_b"] + n * n + 9 * n
    assert rn["values"] == 38 * n
    # every plan fits a CTA's 227 KB and an SM's shared memory TILE_CTAS
    # times, in f32 and f64 (the ∇FD's wherever its kernel is built: up to
    # the 16 joints chip_smoke.py's route checks build it at)
    per_sm = _build.SM_SMEM_BYTES // _build.TILE_CTAS - 1024
    for plan in (rn, fd) if n <= 16 else (rn,):
        assert plan["stride"] % 2 == 1 and plan["stride"] >= plan["values"]
        for dt, size in (("f32", 4), ("f64", 8)):
            assert 1 <= plan["states"][dt] <= _build.TILE_MAX_STATES
            smem = _build.sweep_smem_bytes(plan, n, size, dt)
            assert smem <= min(_build.SMEM_BYTES, per_sm)
    if name == "iiwa14":
        assert (fd["states"], rn["states"]) == ({"f32": 16, "f64": 7},
                                                {"f32": 32, "f64": 32})
    if name == "atlas":
        assert rn["states"] == {"f32": 23, "f64": 9}
    if n > _build.MAX_KERNEL_JOINTS:
        return
    # K5's packed columns cover every nonzero of the ∇FD's ∂ID
    _, df = _build.k5_pattern(parents)
    g = torch.Generator().manual_seed(11)
    q, qd, u = ((torch.rand(n, B, generator=g, dtype=torch.float64) * 2
                 - 1) * r for r in (2.0, 1.0, 8.0))
    qdd = tf.forward_dynamics_plain(m, q, qd, u)
    for dc in tf.id_grad_plain(m, q, qd, qdd):
        nz = (dc != 0).any(-1)
        for i in range(n):
            cols = {k for k in range(n) if nz[i, k]}
            assert cols <= set(df[i]), (i, sorted(cols - set(df[i])))


@pytest.mark.parametrize("name, entry, unit", [
    ("bias_and_v", "grid_bias_v", "staged.cu"),
    ("af", "grid_af", "staged.cu"),
    ("af_bf16", "grid_af", "staged.cu"),
    ("vaf", "grid_vaf", "staged.cu"),
    ("fd_grad", "grid_fd_grad", "fused.cu"),
])
def test_sweep_and_fd_design(name, entry, unit):
    """The sweeps and the recursion ∇FD launch their tiles unless DESIGN
    says "thread": then the one-thread kernels, counted apart; the build
    passes the sweeps' plan and the ∇FD's as -D lists."""
    macros = _build._macros(_build.topology_key(_model("barm")))
    for tag in ("RN_TABLE", "RN_OFFS", "RN_PLAN", "FD_PLAN", "TILE_CTAS"):
        assert sum(x.startswith(f"-DGRID_{tag}=") for x in macros) == 1
    assert _launch.design(name, entry) == (name, entry)
    try:
        _launch.DESIGN = "thread"
        assert _launch.design(name, entry) == (f"{name}_thread",
                                           f"{entry}_thread")
    finally:
        _launch.DESIGN = "tile"
    assert {name, f"{name}_thread"} <= set(_launch.LAUNCHES)
    assert _build.unit_of(entry) == _build.unit_of(f"{entry}_thread") == unit


def test_thread_design_on_cpu_runs_plain():
    """On CPU tensors every wrapper runs its plain version whatever DESIGN
    says, and counts no launch."""
    m = _model("barm")
    g = torch.Generator().manual_seed(3)
    q, qd, u = (torch.rand(m.n, 2, generator=g, dtype=torch.float64)
                for _ in range(3))
    _launch.reset_launches()
    try:
        _launch.DESIGN = "thread"
        got = (tf.fd_grad_fused(m, q, qd, u),
               ts.bias_and_v_staged(m, q, qd), ts.vaf_staged(m, q, qd, u))
    finally:
        _launch.DESIGN = "tile"
    ref = (tf.fd_grad_plain(m, q, qd, u), ts.bias_and_v_plain(m, q, qd),
           ts.vaf_plain(m, q, qd, u))
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert not any(_launch.LAUNCHES.values())
