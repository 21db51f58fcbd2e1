"""Built-in robot fixtures.

The URDF fixtures of ``gridcodegenerator_tpu/models/zoo.py``, copied as
they are: the single-dof robots, and the multi-dof ones — the ball-joint arm
(:func:`ball_arm`), a true 6-dof free joint at a robot's root
(:func:`with_free_joint`) and the revolute rewrite of ball joints
(:func:`expand_spherical`); and the Euler-chain floating base
(:func:`with_floating_base`), the emulation the free-flyer slice is checked
against; the planar four-bar linkage (:func:`four_bar`), whose loop the
stepper's ``loops=`` closes; and the MJCF fixtures, the hinge-legged ant (:func:`ant_mjcf`)
and the ball-hip ant with a free joint (:func:`ball_ant_mjcf`), read by
:mod:`.mjcf`.

The reference relies on external URDFs fed through ``URDFParser``
(``README.md:8,20``); its benchmark configs name iiwa-14
(7-DoF serial), HyQ (branched quadruped) and Atlas (humanoid). This module
generates equivalent URDF documents programmatically so the framework and its
tests are self-contained:

* :func:`iiwa14`        — 7-DoF serial arm (KUKA LBR iiwa 14 style geometry),
* :func:`hyq`           — 12-DoF quadruped, 4-way branch at the trunk.
                          NOTE: the trunk is the *fixed base*, so the four
                          sibling HAA joints have parent −1 — no backward-pass
                          scatter-add fires (``level_has_repeated_parents(0)``
                          is False). Use :func:`branched_arm` for the
                          repeated-*moving*-parent case (the reference's
                          atomicAdd path, ``_inverse_dynamics.py:276-282``),
* :func:`branched_arm`  — 9-DoF dual-arm torso: two 4-DoF arms fan out of a
                          single *moving* torso link (the Atlas utorso
                          pattern), so sibling joints share a moving parent
                          and every backward sweep exercises the scatter-add
                          (atomicAdd-analog) accumulation path,
* :func:`atlas`         — 28-DoF humanoid, deep + wide tree,
* :func:`serial_chain`  — parametric n-DoF chain,
* :func:`random_tree`   — seeded random topology/inertia generator for
                          property tests (general, non-axis-aligned axes).
"""

from __future__ import annotations

import numpy as np

_PI = np.pi


class UrdfWriter:
    def __init__(self, name: str):
        self.name = name
        self.links: list[str] = []
        self.joints: list[str] = []

    def link(self, name, mass=0.0, com=(0, 0, 0), ixx=0.0, iyy=0.0, izz=0.0,
             ixy=0.0, ixz=0.0, iyz=0.0, inertial_rpy=(0, 0, 0)):
        inertial = ""
        if mass > 0:
            inertial = f"""
    <inertial>
      <origin xyz="{com[0]} {com[1]} {com[2]}" rpy="{inertial_rpy[0]} {inertial_rpy[1]} {inertial_rpy[2]}"/>
      <mass value="{mass}"/>
      <inertia ixx="{ixx}" ixy="{ixy}" ixz="{ixz}" iyy="{iyy}" iyz="{iyz}" izz="{izz}"/>
    </inertial>"""
        self.links.append(f'  <link name="{name}">{inertial}\n  </link>')
        return self

    def joint(self, name, parent, child, jtype="revolute", xyz=(0, 0, 0),
              rpy=(0, 0, 0), axis=(0, 0, 1), damping=0.0, limit=2.96,
              mimic=None):
        lim = ""
        if jtype == "revolute":
            lim = f'\n    <limit lower="{-limit}" upper="{limit}" effort="300" velocity="10"/>'
        elif jtype == "prismatic":
            lim = f'\n    <limit lower="-1" upper="1" effort="300" velocity="10"/>'
        mim = ""
        if mimic is not None:
            src, mult, off = mimic
            mim = (f'\n    <mimic joint="{src}" multiplier="{mult}" '
                   f'offset="{off}"/>')
        self.joints.append(f"""  <joint name="{name}" type="{jtype}">
    <parent link="{parent}"/>
    <child link="{child}"/>
    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/>
    <axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>
    <dynamics damping="{damping}" friction="0"/>{lim}{mim}
  </joint>""")
        return self

    def build(self) -> str:
        body = "\n".join(self.links + self.joints)
        return f'<robot name="{self.name}">\n{body}\n</robot>\n'


def iiwa14(damping: float = 0.0) -> str:
    """7-DoF serial arm with KUKA LBR iiwa 14 R820 style kinematics/inertias."""
    b = UrdfWriter("iiwa14")
    b.link("link_0", mass=5.0, com=(-0.1, 0, 0.07), ixx=0.05, iyy=0.06, izz=0.03)
    masses = [3.4525, 3.4821, 4.05623, 3.4822, 2.1633, 2.3466, 3.129]
    coms = [(0, -0.03, 0.12), (0.0003, 0.059, 0.042), (0, 0.03, 0.13),
            (0, 0.067, 0.034), (0.0001, 0.021, 0.076), (0, 0.0006, 0.0004),
            (0, 0, 0.02)]
    diags = [(0.02183, 0.007703, 0.02083), (0.02076, 0.02179, 0.00779),
             (0.03204, 0.00972, 0.03042), (0.02178, 0.02075, 0.007785),
             (0.01287, 0.005708, 0.01112), (0.006509, 0.006259, 0.004527),
             (0.01464, 0.01465, 0.002872)]
    for i in range(7):
        d = diags[i]
        b.link(f"link_{i+1}", mass=masses[i], com=coms[i],
               ixx=d[0], iyy=d[1], izz=d[2])
    origins = [((0, 0, 0.1575), (0, 0, 0)),
               ((0, 0, 0.2025), (_PI / 2, 0, _PI)),
               ((0, 0.2045, 0), (_PI / 2, 0, _PI)),
               ((0, 0, 0.2155), (_PI / 2, 0, 0)),
               ((0, 0.1845, 0), (-_PI / 2, _PI, 0)),
               ((0, 0, 0.2155), (_PI / 2, 0, 0)),
               ((0, 0.081, 0), (-_PI / 2, _PI, 0))]
    for i, (xyz, rpy) in enumerate(origins):
        b.joint(f"joint_{i+1}", f"link_{i}", f"link_{i+1}",
                xyz=xyz, rpy=rpy, axis=(0, 0, 1), damping=damping)
    return b.build()


def panda(damping: float = 0.0) -> str:
    """7-DoF serial arm with Franka Emika Panda style kinematics/inertias."""
    b = UrdfWriter("panda")
    b.link("panda_link0", mass=2.9, com=(-0.03, 0, 0.06), ixx=0.01, iyy=0.01, izz=0.007)
    masses = [4.97, 0.65, 3.23, 3.59, 1.23, 1.67, 0.735]
    coms = [(0.0039, 0.0021, -0.0475), (-0.0031, -0.0284, 0.0032),
            (0.0443, 0.0249, -0.0038), (-0.0386, 0.0395, 0.0249),
            (-0.0064, 0.0389, -0.1097), (0.0605, 0.0142, 0.0105),
            (0.0104, -0.0042, 0.0614)]
    diags = [(0.7035, 0.7066, 0.0091), (0.0079, 0.0280, 0.0256),
             (0.0373, 0.0362, 0.0109), (0.0256, 0.0196, 0.0128),
             (0.0357, 0.0291, 0.0086), (0.0019, 0.0044, 0.0054),
             (0.0125, 0.0103, 0.0049)]
    for i in range(7):
        d = diags[i]
        b.link(f"panda_link{i+1}", mass=masses[i], com=coms[i],
               ixx=d[0], iyy=d[1], izz=d[2])
    origins = [((0, 0, 0.333), (0, 0, 0)),
               ((0, 0, 0), (-_PI / 2, 0, 0)),
               ((0, -0.316, 0), (_PI / 2, 0, 0)),
               ((0.0825, 0, 0), (_PI / 2, 0, 0)),
               ((-0.0825, 0.384, 0), (-_PI / 2, 0, 0)),
               ((0, 0, 0), (_PI / 2, 0, 0)),
               ((0.088, 0, 0), (_PI / 2, 0, 0))]
    for i, (xyz, rpy) in enumerate(origins):
        b.joint(f"panda_joint{i+1}", f"panda_link{i}", f"panda_link{i+1}",
                xyz=xyz, rpy=rpy, axis=(0, 0, 1), damping=damping)
    return b.build()


def hyq(damping: float = 0.0) -> str:
    """12-DoF fixed-trunk quadruped (HyQ-style): 4 legs × (HAA, HFE, KFE)."""
    b = UrdfWriter("hyq")
    b.link("trunk", mass=60.96, com=(0.0, 0.0, 0.02),
           ixx=1.5, iyy=8.5, izz=9.2)
    legs = {"lf": (0.3735, 0.207), "rf": (0.3735, -0.207),
            "lh": (-0.3735, 0.207), "rh": (-0.3735, -0.207)}
    for leg, (x, y) in legs.items():
        mirror = -1.0 if y < 0 else 1.0
        b.link(f"{leg}_hipassembly", mass=2.93, com=(0.04, 0.0, 0.0),
               ixx=0.005, iyy=0.0087, izz=0.0069)
        b.link(f"{leg}_upperleg", mass=2.638, com=(0.15, mirror * 0.026, 0.0),
               ixx=0.0046, iyy=0.0535, izz=0.0548)
        b.link(f"{leg}_lowerleg", mass=0.881, com=(0.125, 0.0001, -0.0003),
               ixx=0.0007, iyy=0.0128, izz=0.0127)
        b.joint(f"{leg}_haa_joint", "trunk", f"{leg}_hipassembly",
                xyz=(x, y, 0.0), rpy=(0, _PI / 2, 0), axis=(0, 0, 1),
                damping=damping)
        b.joint(f"{leg}_hfe_joint", f"{leg}_hipassembly", f"{leg}_upperleg",
                xyz=(0.08, 0, 0), rpy=(-_PI / 2 * mirror, 0, 0), axis=(0, 0, 1),
                damping=damping)
        b.joint(f"{leg}_kfe_joint", f"{leg}_upperleg", f"{leg}_lowerleg",
                xyz=(0.35, 0, 0), rpy=(0, 0, 0), axis=(0, 0, 1),
                damping=damping)
    return b.build()


def branched_arm(damping: float = 0.0) -> str:
    """9-DoF dual-arm torso: base → torso (moving) → 2 × 4-DoF arms.

    The two shoulder joints share the *moving* torso link as parent (the
    Atlas utorso fan-out pattern), so the RNEA / M⁻¹ / ∂ID backward sweeps
    all hit the repeated-parent accumulation path (the reference's atomicAdd
    sites, ``algorithms/_inverse_dynamics.py:276-282``,
    ``_direct_minv.py:266-271``, ``_inverse_dynamics_gradient.py:534-539``)
    on a robot small enough for default-suite ``jax.jacfwd`` cross-checks."""
    b = UrdfWriter("branched_arm")
    b.link("base", mass=4.0, ixx=0.05, iyy=0.05, izz=0.03)
    b.link("torso", mass=8.0, com=(0.0, 0.01, 0.2), ixx=0.3, iyy=0.28, izz=0.1)
    b.joint("waist", "base", "torso", xyz=(0, 0, 0.2), axis=(0, 0, 1),
            damping=damping)
    arm_masses = [2.2, 1.8, 1.3, 0.6]
    arm_diags = [(0.012, 0.011, 0.004), (0.009, 0.008, 0.003),
                 (0.005, 0.005, 0.002), (0.002, 0.002, 0.001)]
    axes = [(0, 1, 0), (1, 0, 0), (0, 0, 1), (0, 1, 0)]
    for side, m in (("l", 1.0), ("r", -1.0)):
        parent = "torso"
        for k in range(4):
            nm = f"{side}_arm{k}"
            b.link(nm, mass=arm_masses[k], com=(0.01, m * 0.02, -0.08),
                   ixx=arm_diags[k][0], iyy=arm_diags[k][1], izz=arm_diags[k][2])
            xyz = (0.05, m * 0.18, 0.35) if k == 0 else (0.01, m * 0.02, -0.22)
            b.joint(f"{side}_j{k}", parent, nm, xyz=xyz,
                    rpy=(0.1 * m * k, -0.05 * k, 0.0), axis=axes[k],
                    damping=damping)
            parent = nm
    return b.build()


def atlas(damping: float = 0.0) -> str:
    """28-DoF stylized humanoid (Atlas-scale tree: torso chain, neck, two
    6-DoF arms, two 6-DoF legs; wide waves + depth 9)."""
    b = UrdfWriter("atlas")
    b.link("pelvis", mass=17.88, com=(0.01, 0, 0.03), ixx=0.12, iyy=0.11, izz=0.11)

    def seg(name, mass, com, d):
        b.link(name, mass=mass, com=com, ixx=d[0], iyy=d[1], izz=d[2])

    # torso chain: pelvis → ltorso → mtorso → utorso
    seg("ltorso", 2.4, (-0.01, 0, 0.07), (0.0039, 0.0034, 0.0031))
    seg("mtorso", 0.69, (-0.008, -0.01, 0.3), (0.00045, 0.00041, 0.00041))
    seg("utorso", 52.0, (-0.08, 0, 0.29), (1.47, 1.42, 0.83))
    b.joint("back_bkz", "pelvis", "ltorso", xyz=(-0.0125, 0, 0), axis=(0, 0, 1), damping=damping, limit=0.66)
    b.joint("back_bky", "ltorso", "mtorso", xyz=(0, 0, 0.162), axis=(0, 1, 0), damping=damping)
    b.joint("back_bkx", "mtorso", "utorso", xyz=(0, 0, 0.05), axis=(1, 0, 0), damping=damping)
    # neck
    seg("head", 1.42, (-0.008, 0, 0.03), (0.0042, 0.0057, 0.0045))
    b.joint("neck_ry", "utorso", "head", xyz=(0.2546, 0, 0.6215), axis=(0, 1, 0), damping=damping)
    # arms
    arm_masses = [4.47, 3.45, 3.01, 3.39, 2.58, 0.65]
    arm_diags = [(0.011, 0.009, 0.004), (0.015, 0.007, 0.012), (0.004, 0.003, 0.003),
                 (0.004, 0.003, 0.003), (0.002, 0.002, 0.001), (0.001, 0.001, 0.001)]
    for side, m in (("l", 1.0), ("r", -1.0)):
        names = [f"{side}_clav", f"{side}_scap", f"{side}_uarm",
                 f"{side}_larm", f"{side}_farm", f"{side}_hand"]
        for nm, mass, d in zip(names, arm_masses, arm_diags):
            seg(nm, mass, (0, m * 0.05, -0.02), d)
        b.joint(f"{side}_arm_shz", "utorso", names[0],
                xyz=(0.1406, m * 0.2256, 0.4776), axis=(0, 0, 1), damping=damping)
        b.joint(f"{side}_arm_shx", names[0], names[1],
                xyz=(0, m * 0.11, -0.245), axis=(1, 0, 0), damping=damping)
        b.joint(f"{side}_arm_ely", names[1], names[2],
                xyz=(0, m * 0.187, -0.016), axis=(0, 1, 0), damping=damping)
        b.joint(f"{side}_arm_elx", names[2], names[3],
                xyz=(0, m * 0.119, 0.0092), axis=(1, 0, 0), damping=damping)
        b.joint(f"{side}_arm_wry", names[3], names[4],
                xyz=(0, m * 0.29955, -0.0092), axis=(0, 1, 0), damping=damping)
        b.joint(f"{side}_arm_wrx", names[4], names[5],
                xyz=(0, m * 0.1, 0), axis=(1, 0, 0), damping=damping)
    # legs
    leg_masses = [3.69, 3.41, 8.21, 4.52, 4.1, 2.41]
    leg_diags = [(0.008, 0.007, 0.008), (0.009, 0.008, 0.007), (0.09, 0.09, 0.02),
                 (0.077, 0.076, 0.01), (0.002, 0.002, 0.002), (0.002, 0.007, 0.008)]
    for side, m in (("l", 1.0), ("r", -1.0)):
        names = [f"{side}_uglut", f"{side}_lglut", f"{side}_uleg",
                 f"{side}_lleg", f"{side}_talus", f"{side}_foot"]
        for nm, mass, d in zip(names, leg_masses, leg_diags):
            seg(nm, mass, (0.005, m * 0.01, -0.03), d)
        b.joint(f"{side}_leg_hpz", "pelvis", names[0],
                xyz=(0, m * 0.089, 0), axis=(0, 0, 1), damping=damping, limit=0.78)
        b.joint(f"{side}_leg_hpx", names[0], names[1],
                xyz=(0, 0, 0), axis=(1, 0, 0), damping=damping, limit=0.52)
        b.joint(f"{side}_leg_hpy", names[1], names[2],
                xyz=(0.05, m * 0.0225, -0.066), axis=(0, 1, 0), damping=damping)
        b.joint(f"{side}_leg_kny", names[2], names[3],
                xyz=(-0.05, 0, -0.374), axis=(0, 1, 0), damping=damping)
        b.joint(f"{side}_leg_aky", names[3], names[4],
                xyz=(0, 0, -0.422), axis=(0, 1, 0), damping=damping)
        b.joint(f"{side}_leg_akx", names[4], names[5],
                xyz=(0, 0, 0), axis=(1, 0, 0), damping=damping, limit=0.8)
    return b.build()


def serial_chain(n: int, damping: float = 0.0, prismatic_every: int = 0) -> str:
    """Parametric n-DoF serial chain with alternating axes."""
    b = UrdfWriter(f"chain{n}")
    b.link("base", mass=1.0, ixx=0.01, iyy=0.01, izz=0.01)
    axes = [(0, 0, 1), (0, 1, 0), (1, 0, 0)]
    for i in range(n):
        b.link(f"l{i+1}", mass=1.0 + 0.1 * i, com=(0.02, 0.01, 0.15),
               ixx=0.02 + 0.001 * i, iyy=0.018, izz=0.006, ixy=0.0005)
        jtype = "prismatic" if (prismatic_every and (i + 1) % prismatic_every == 0) else "revolute"
        b.joint(f"j{i+1}", "base" if i == 0 else f"l{i}", f"l{i+1}",
                jtype=jtype, xyz=(0.01 * (i % 3), 0.02, 0.25),
                rpy=(0.1 * (i % 5), -0.07 * (i % 3), 0.05 * i),
                axis=axes[i % 3], damping=damping)
    return b.build()


def random_tree(n: int, seed: int = 0, branch_prob: float = 0.35,
                with_damping: bool = True, general_axes: bool = True) -> str:
    """Seeded random kinematic tree with physically valid (PD) inertias.

    Exercises branched topologies, repeated parents, general (non-one-hot)
    joint axes, and mixed revolute/prismatic joints — a strict superset of
    what the reference supports (it requires one-hot S,
    ``helpers/_spatial_algebra_helpers.py:13``).
    """
    rng = np.random.default_rng(seed)
    b = UrdfWriter(f"rand{n}_{seed}")
    b.link("base", mass=2.0, ixx=0.02, iyy=0.02, izz=0.02)
    parents = []
    for i in range(n):
        if i == 0 or rng.random() > branch_prob:
            parents.append(i - 1)  # extend the chain
        else:
            parents.append(int(rng.integers(-1, i)))
    for i in range(n):
        mass = float(rng.uniform(0.5, 4.0))
        com = rng.uniform(-0.1, 0.1, 3)
        A = rng.uniform(-0.1, 0.1, (3, 3))
        I = A @ A.T + 0.01 * np.eye(3)
        b.link(f"l{i+1}", mass=mass, com=com,
               ixx=I[0, 0], iyy=I[1, 1], izz=I[2, 2],
               ixy=I[0, 1], ixz=I[0, 2], iyz=I[1, 2])
        if general_axes and rng.random() < 0.3:
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
        else:
            ax = np.eye(3)[rng.integers(0, 3)]
        jtype = "prismatic" if rng.random() < 0.15 else "revolute"
        parent_link = "base" if parents[i] == -1 else f"l{parents[i]+1}"
        b.joint(f"j{i+1}", parent_link, f"l{i+1}", jtype=jtype,
                xyz=rng.uniform(-0.3, 0.3, 3), rpy=rng.uniform(-_PI, _PI, 3),
                axis=tuple(ax),
                damping=float(rng.uniform(0.0, 0.5)) if with_damping else 0.0)
    return b.build()


def double_pendulum(l1: float = 1.0, l2: float = 1.0,
                    m1: float = 1.0, m2: float = 1.0) -> str:
    """Planar double pendulum (point masses, rotation about y) — used for
    closed-form analytic validation of the dynamics conventions."""
    b = UrdfWriter("double_pendulum")
    b.link("base")
    b.link("rod1", mass=m1, com=(0, 0, -l1))
    b.link("rod2", mass=m2, com=(0, 0, -l2))
    b.joint("hinge1", "base", "rod1", axis=(0, 1, 0), limit=10)
    b.joint("hinge2", "rod1", "rod2", xyz=(0, 0, -l1), axis=(0, 1, 0), limit=10)
    return b.build()


def four_bar(damping: float = 0.0, ground: float = 0.8,
             crank: float = 0.5, coupler: float = 0.8) -> str:
    """Planar parallelogram four-bar linkage (rotation about y, motion in
    the xz-plane) — the closed-kinematic-chain fixture for the loop-closure
    layer (``ops/loops.py``). URDF can only express the spanning TREE
    (base→crank→coupler plus base→rocker); the loop is restored by the
    connect constraint

        coupler point (coupler, 0, 0)  ==  rocker point (0, 0, −crank),

    which is exactly satisfied in the assembled configuration q = 0
    (crank tip at (0,0,−crank), coupler extends +x by ``coupler = ground``;
    rocker hangs from (ground,0,0) to (ground,0,−crank)). One mechanism
    DOF. Link indices by name via ``Topology.link_names``:
    crank, coupler, rocker."""
    b = UrdfWriter("four_bar")
    b.link("base", mass=2.0, ixx=0.02, iyy=0.02, izz=0.02)
    b.link("crank", mass=1.0, com=(0, 0, -crank / 2),
           ixx=0.02, iyy=0.02, izz=0.004)
    b.link("coupler", mass=0.8, com=(coupler / 2, 0, 0),
           ixx=0.003, iyy=0.018, izz=0.018)
    b.link("rocker", mass=1.0, com=(0, 0, -crank / 2),
           ixx=0.02, iyy=0.02, izz=0.004)
    b.joint("j_crank", "base", "crank", axis=(0, 1, 0), damping=damping,
            limit=10)
    b.joint("j_coupler", "crank", "coupler", xyz=(0, 0, -crank),
            axis=(0, 1, 0), damping=damping, limit=10)
    b.joint("j_rocker", "base", "rocker", xyz=(ground, 0, 0),
            axis=(0, 1, 0), damping=damping, limit=10)
    return b.build()


def with_floating_base(urdf: str, *, name_suffix: str = "_floating") -> str:
    """Give a fixed-base URDF a 6-DoF floating base.

    The reference supports only single-dof joints (S is a one-hot 6-vector,
    ``_spatial_algebra_helpers.py:13``), so floating-base robots (HyQ, Atlas
    in GRiD's benchmark set) are modeled the standard way: a chain of six
    single-dof joints — three prismatic (x, y, z translation) then three
    revolute (z, y, x rotation) — between a massless world anchor and the
    robot's root link. This is an exact parameterization of free-flyer
    dynamics away from the Euler-angle singularity at pitch = ±π/2.
    """
    import re
    import xml.etree.ElementTree as ET

    root = ET.fromstring(urdf)
    robot_name = root.get("name", "robot") + name_suffix
    links = {l.get("name") for l in root.findall("link")}
    children = {j.find("child").get("link") for j in root.findall("joint")}
    roots = sorted(links - children)
    if len(roots) != 1:
        raise ValueError(f"expected one root link, found {roots}")
    base = roots[0]

    chain = [("fb_px", "prismatic", (1, 0, 0)), ("fb_py", "prismatic", (0, 1, 0)),
             ("fb_pz", "prismatic", (0, 0, 1)), ("fb_rz", "revolute", (0, 0, 1)),
             ("fb_ry", "revolute", (0, 1, 0)), ("fb_rx", "revolute", (1, 0, 0))]
    extra_links = []
    extra_joints = []
    parent = "world"
    for idx, (jn, jt, ax) in enumerate(chain):
        child = base if idx == len(chain) - 1 else f"fb_link{idx}"
        if child != base:
            extra_links.append(f'  <link name="{child}"/>')
        lim = ('<limit lower="-100" upper="100" effort="1e6" velocity="1e6"/>'
               if jt == "prismatic" else
               '<limit lower="-50" upper="50" effort="1e6" velocity="1e6"/>')
        extra_joints.append(f"""  <joint name="{jn}" type="{jt}">
    <parent link="{parent}"/>
    <child link="{child}"/>
    <origin xyz="0 0 0" rpy="0 0 0"/>
    <axis xyz="{ax[0]} {ax[1]} {ax[2]}"/>
    {lim}
  </joint>""")
        parent = child

    body = urdf[urdf.index(">", urdf.index("<robot")) + 1:urdf.rindex("</robot>")]
    return (f'<robot name="{robot_name}">\n  <link name="world"/>\n'
            + "\n".join(extra_links) + "\n" + "\n".join(extra_joints)
            + body + "</robot>\n")


def with_free_joint(urdf: str, *, name_suffix: str = "_free") -> str:
    """Give a fixed-base URDF a TRUE 6-DoF floating joint (quaternion
    attitude + position — the multi-dof stack's ``"floating"`` type, no
    Euler singularity), connecting a massless world anchor to the robot's
    root link. Build the result with
    :func:`..ops.multidof.multidof_model_from_description`; validated
    against the dedicated free-flyer module (tests/test_multidof.py)."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(urdf)
    robot_name = root.get("name", "robot") + name_suffix
    links = {l.get("name") for l in root.findall("link")}
    children = {j.find("child").get("link") for j in root.findall("joint")}
    roots = sorted(links - children)
    if len(roots) != 1:
        raise ValueError(f"expected one root link, found {roots}")
    base = roots[0]

    joint = f"""  <joint name="free_base" type="floating">
    <parent link="world"/>
    <child link="{base}"/>
    <origin xyz="0 0 0" rpy="0 0 0"/>
  </joint>"""
    body = urdf[urdf.index(">", urdf.index("<robot")) + 1:urdf.rindex("</robot>")]
    return (f'<robot name="{robot_name}">\n  <link name="world"/>\n'
            + joint + body + "</robot>\n")


def ball_arm(damping: float = 0.0) -> str:
    """3-joint arm with two spherical (3-dof) joints: base → ball shoulder →
    revolute elbow → ball wrist (nq = 9, nv = 7). The fixture for the
    multi-dof (6,k)-subspace stack (`ops/multidof.py`) — beyond the
    reference's single-dof-only capability."""
    b = UrdfWriter("ball_arm")
    b.link("base", mass=3.0, ixx=0.03, iyy=0.03, izz=0.02)
    b.link("upper", mass=2.4, com=(0.02, 0.01, -0.12), ixx=0.015, iyy=0.014,
           izz=0.004, ixy=0.0008)
    b.link("fore", mass=1.6, com=(0.01, 0.0, -0.11), ixx=0.009, iyy=0.009,
           izz=0.002)
    b.link("hand", mass=0.7, com=(0.0, 0.01, -0.05), ixx=0.002, iyy=0.002,
           izz=0.001)
    b.joint("shoulder", "base", "upper", jtype="spherical",
            xyz=(0.05, 0.0, 0.15), rpy=(0.1, -0.05, 0.2), damping=damping)
    b.joint("elbow", "upper", "fore", jtype="revolute",
            xyz=(0.0, 0.02, -0.26), rpy=(0.0, 0.1, 0.0), axis=(0, 1, 0),
            damping=damping)
    b.joint("wrist", "fore", "hand", jtype="spherical",
            xyz=(0.01, 0.0, -0.24), rpy=(-0.07, 0.0, 0.05), damping=damping)
    return b.build()


def expand_spherical(urdf: str) -> str:
    """Rewrite every spherical joint as an exactly equivalent z–y–x chain of
    three zero-offset revolute joints (massless intermediate links) — the
    only encoding the single-dof stack (and the reference) can consume.
    Exact away from the chain's gimbal lock at the middle angle ±π/2; used
    to cross-validate `ops/multidof.py` against the single-dof stack."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(urdf)
    new_links = []
    for j in list(root.findall("joint")):
        if j.get("type") != "spherical":
            continue
        name = j.get("name")
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        o = j.find("origin")
        xyz = o.get("xyz", "0 0 0") if o is not None else "0 0 0"
        rpy = o.get("rpy", "0 0 0") if o is not None else "0 0 0"
        dyn = j.find("dynamics")
        damping = dyn.get("damping", "0") if dyn is not None else "0"
        root.remove(j)
        chain = [("z", "0 0 1"), ("y", "0 1 0"), ("x", "1 0 0")]
        prev = parent
        for k, (suffix, ax) in enumerate(chain):
            is_last = k == len(chain) - 1
            nxt = child if is_last else f"{name}_l{suffix}"
            if not is_last:
                new_links.append(nxt)
            je = ET.SubElement(root, "joint",
                               dict(name=f"{name}_{suffix}", type="revolute"))
            ET.SubElement(je, "parent", dict(link=prev))
            ET.SubElement(je, "child", dict(link=nxt))
            ET.SubElement(je, "origin",
                          dict(xyz=xyz if k == 0 else "0 0 0",
                               rpy=rpy if k == 0 else "0 0 0"))
            ET.SubElement(je, "axis", dict(xyz=ax))
            ET.SubElement(je, "dynamics", dict(damping=damping, friction="0"))
            ET.SubElement(je, "limit", dict(lower="-10", upper="10",
                                            effort="1e6", velocity="1e6"))
            prev = nxt
    for ln in new_links:
        ET.SubElement(root, "link", dict(name=ln))
    return ET.tostring(root, encoding="unicode")



def ant_mjcf(damping: float = 0.5, sensors: bool = False) -> str:
    """MuJoCo-style quadruped 'ant' as an MJCF document (the MJCF front-end
    fixture): torso sphere welded to the root (its inertia lands in
    ``base_inertia`` — the free-flyer base), four 2-joint legs mounted at
    90° yaw increments via DEGREE-mode eulers, capsule geoms supplying the
    inertia (no explicit <inertial> — exercises geom-derived mass), a
    <default> class tree for the joints, joint ranges, foot <site>
    anchors at the shin capsule tips (offsets (0.4, 0, 0) on the shin
    links — read them with ``mjcf_sites``), and an <actuator> block of
    torque motors (gear 30, ctrlrange ±1 — ``mjcf_actuators``)."""
    legs, motors = [], []
    for k in range(4):
        ang = 45 + 90 * k
        legs.append(f"""
    <body name="hip{k}" pos="0.2 0 0" euler="0 0 {ang}">
      <joint name="hip{k}_j" axis="0 0 1" range="-35 35"/>
      <geom type="capsule" size="0.046" fromto="0 0 0 0.28 0 0"/>
      <body name="shin{k}" pos="0.28 0 0">
        <joint name="knee{k}_j" axis="0 1 0" range="25 100" class="knee"/>
        <geom type="capsule" size="0.046" fromto="0 0 0 0.4 0 0"/>
        <site name="foot{k}" pos="0.4 0 0"/>
      </body>
    </body>""")
        motors.append(
            f'    <motor name="m_hip{k}" joint="hip{k}_j"/>\n'
            f'    <motor name="m_knee{k}" joint="knee{k}_j" gear="45"/>')
    # sensors=True appends a torso IMU site + the standard MuJoCo RL
    # sensor suite (IMU triple, world trackers, encoders on leg 0, foot
    # touch sensors, one actuator-force readout) — the mjcf_sensors
    # fixture
    sens = "" if not sensors else f"""
  <sensor>
    <gyro name="gyro" site="imu"/>
    <accelerometer name="acc" site="imu"/>
    <velocimeter name="vel" site="imu"/>
    <framepos name="imu_pos" objtype="site" objname="imu"/>
    <framequat name="imu_quat" objtype="site" objname="imu"/>
    <framelinvel name="imu_linvel" objtype="site" objname="imu"/>
    <frameangvel name="imu_angvel" objtype="site" objname="imu"/>
    <jointpos name="hip0_pos" joint="hip0_j"/>
    <jointvel name="knee0_vel" joint="knee0_j"/>
    {''.join(f'<touch name="touch{k}" site="foot{k}"/>' for k in range(4))}
    <actuatorfrc name="f_hip0" actuator="m_hip0"/>
  </sensor>"""
    imu = '<site name="imu" pos="0 0 0.05"/>' if sensors else ""
    return f"""
<mujoco model="ant">
  <compiler angle="degree"/>
  <default>
    <joint damping="{damping}" armature="0.01"/>
    <default class="knee"><joint damping="{2 * damping}"/></default>
    <geom density="900"/>
    <motor gear="30" ctrlrange="-1 1"/>
  </default>
  <worldbody>
    <body name="torso">
      <geom type="sphere" size="0.25" density="400"/>
      {imu}
      {''.join(legs)}
    </body>
  </worldbody>
  <actuator>
{chr(10).join(motors)}
  </actuator>{sens}
</mujoco>
"""


def ball_ant_mjcf(damping: float = 1.2, sensors: bool = False) -> str:
    """Free-floating quadruped with BALL (3-dof spherical) hips and revolute
    knees — the multi-dof contact fixture (freejoint base ⊕ 4×(ball ⊕
    hinge): nq = 7+4·(4+1) = 27, nv = 6+4·(3+1) = 22). Foot <site> anchors
    at the shin tips; one torso sphere geom for geom-vs-ground contact.
    The multi-dof ground step's robot (``md_step_ground_batched``;
    ``chip_smoke.py`` runs it at full width on the card)."""
    legs = []
    for k in range(4):
        ang = 45 + 90 * k
        legs.append(f"""
      <body name="hip{k}" pos="0.18 0 0" euler="0 0 {ang}">
        <joint name="hip{k}_j" type="ball" damping="{damping}"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0.22 0 0"/>
        <body name="shin{k}" pos="0.22 0 0">
          <joint name="knee{k}_j" axis="0 1 0" damping="{damping}"/>
          <geom type="capsule" size="0.04" fromto="0 0 0 0.3 0 0"/>
          <site name="foot{k}" pos="0.3 0 0"/>
        </body>
      </body>""")
    sens = "" if not sensors else """
  <sensor>
    <gyro name="gyro" site="imu"/>
    <accelerometer name="acc" site="imu"/>
    <velocimeter name="vel" site="imu"/>
    <framepos name="imu_pos" objtype="site" objname="imu"/>
    <jointvel name="knee0_vel" joint="knee0_j"/>
    <touch name="touch0" site="foot0"/>
  </sensor>"""
    imu = '<site name="imu" pos="0 0 0.04"/>' if sensors else ""
    return f"""
<mujoco model="ball_ant"><compiler angle="degree"/>
  <default><geom density="800"/></default>
  <worldbody><body name="torso"><freejoint/>
    <geom type="sphere" size="0.18" density="500"/>
    {imu}
    {''.join(legs)}
  </body></worldbody>{sens}</mujoco>"""


ZOO = {
    "iiwa14": iiwa14,
    "panda": panda,
    "hyq": hyq,
    "branched_arm": branched_arm,
    "atlas": atlas,
    "double_pendulum": double_pendulum,
}
