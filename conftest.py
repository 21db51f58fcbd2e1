"""How the default test tier of ``tests/`` is cut and bounded.

Three rules for the tests under ``tests/`` (TIER1.md records the runs they
were tuned on, with each test's seconds):

- the port's tests (``tests/test_torch_*.py``) are handed out first, so that
  a run cut short has already checked the code that changes;
- every test outside ``slow`` has ``TEST_LIMIT_S`` for its setup, call and
  teardown, after which its process prints every thread's stack and exits:
  under xdist that ends one worker, which xdist reports as failed under the
  test's own name and replaces; without xdist it ends the run;
- the JAX package's slowest tests (``SLOW_CASES``) and the examples are
  ``slow``, so that ``-m 'not slow'`` leaves them out and ``-m slow`` runs
  them.

``tests/conftest.py`` sets up JAX for the suite; this file imports nothing of
it.
"""

import faulthandler
import os
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

# A test that runs past this many seconds is taken to hang. Every test of the
# default tier runs well inside it (TIER1.md). Tests marked `slow` are the
# ones that run long, so that opt-in tier is not bounded.
TEST_LIMIT_S = 180
_STDERR_FD = pytest.StashKey[int]()


def _in_tests(item):
    return item.path.parent == TESTS


def pytest_configure(config):
    # Duplicated here, while pytest captures no output, so that a hung test's
    # stack reaches the terminal and not the capture file its worker loses.
    config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not _in_tests(item) or item.get_closest_marker("slow"):
        return (yield)
    faulthandler.dump_traceback_later(
        TEST_LIMIT_S, exit=True, file=item.config.stash[_STDERR_FD])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


# The JAX package's tests that take 20 s or more of a worker's time with a warm
# compile cache (TIER1.md gives each one's seconds). They run only under
# `-m slow`, so that the default tier ends inside half the time it is given.
# The port's tests (test_torch_*.py) are never listed here.
SLOW_CASES = frozenset(f"tests/{case}" for case in """
test_armature.py::test_fused_kernels_with_armature
test_batch.py::test_map_batched_chunked_dispatch
test_blops.py::test_accurate_trig_parity[hyq]
test_blops.py::test_accurate_trig_parity[iiwa14]
test_blops.py::test_crba_and_dense_minv_staged[chain5p]
test_blops.py::test_crba_and_dense_minv_staged[hyq]
test_blops.py::test_crba_and_dense_minv_staged[iiwa14]
test_blops.py::test_lane_tile_kernels_interpret[hyq]
test_blops.py::test_pallas_interpret_fd_grad[hyq]
test_blops.py::test_pallas_interpret_fd_grad_dense_minv[hyq]
test_blops.py::test_staged_bf16_staging[hyq]
test_blops.py::test_staged_pipeline_interpret[hyq]
test_blops.py::test_staged_pipeline_interpret[iiwa14]
test_contact.py::test_fb_constrained_batched_matches_single
test_contact.py::test_fb_constrained_linearize_vs_fd
test_contact.py::test_fb_ground_batched_rollout_all_settle
test_contact.py::test_fb_step_ground_batched_matches_single
test_contact.py::test_fb_step_ground_batched_per_env_mu
test_contact.py::test_joint_limits_and_effort_in_ground_stepper
test_contact_fused.py::test_stance_fused_interpret_matches_xla
test_contact_fused.py::test_stance_fused_xla_fallback_path
test_contact_fused.py::test_step_ground_fused_base_geom_matches_xla
test_contact_fused.py::test_step_ground_fused_collision_matches_xla
test_contact_fused.py::test_step_ground_fused_ground_geoms_matches_xla
test_contact_fused.py::test_step_ground_terrain_fused_interpret_matches_xla
test_contact_fused.py::test_step_ground_terrain_large_grid_falls_back
test_diffcontact.py::test_bptt_rollout_implicit_matches_unroll
test_diffcontact.py::test_pgs_bl_implicit_matches_single
test_diffcontact.py::test_step_ground_batched_implicit_matches_unroll
test_diffcontact.py::test_step_ground_implicit_grad_vs_fd
test_envs.py::test_collision_and_ground_geoms_compose
test_envs.py::test_demoted_fb_vs_md_agree
test_envs.py::test_position_servo_actuators
test_envs.py::test_reset_step_shapes_md
test_envs.py::test_rollout_matches_stepping
test_features.py::test_compile_multidof
test_fext.py::test_frictionloss_batched_matches_single_and_grad
test_fext.py::test_step_ground_push_batched_matches_single
test_impl_routing.py::test_second_order_entries_on_cpu[pallas]
test_loops.py::test_fb_loop_fd_batched_matches_vmap
test_loops.py::test_loop_fd_batched_couplings_and_pairs
test_loops.py::test_loop_fd_batched_matches_vmap
test_loops.py::test_loop_step_batched_world_pin
test_md_contact.py::test_md_step_ground_fused_interpret_matches_vmap
test_md_limits.py::test_fb_md_limits_frictionloss_cross_route
test_md_limits.py::test_md_effort_clamp_matches_manual
test_md_loops.py::test_md_weld_end_to_end_from_mjcf
test_md_loops.py::test_md_weld_holds_relative_pose
test_multidof.py::test_floating_joint_matches_freeflyer_module
test_multidof_fused.py::test_md_grad_batched_matches_single[free]
test_multidof_fused.py::test_md_staged_interpret[free]
test_multidof_fused.py::test_md_staged_matches_fused[free]
test_sensors.py::test_rollout_collects_sensordata
test_sharding.py::test_dp_sharded_matches_local
test_sharding.py::test_sharded_api_full_coverage
test_sharding.py::test_sharded_fused_equals_sharded_vmap
test_sharding.py::test_sharded_ground_step
test_sharding.py::test_sharded_md_fd_grad
test_so.py::test_fd_hessian_batch_last_equivalence[barm]
test_so.py::test_fd_hessian_batch_last_equivalence[dpend]
test_so.py::test_fd_hessian_batch_last_equivalence[iiwa14]
test_so.py::test_fd_hessian_vs_nested_ad[chain5p]
test_so.py::test_fd_hessian_vs_nested_ad[dpend]
test_so.py::test_fd_hessian_vs_nested_ad[iiwa14]
test_so.py::test_hessian_api_batched
test_so.py::test_id_hessian_vs_nested_ad[chain5p]
test_so.py::test_id_hessian_vs_nested_ad[dpend]
test_so.py::test_id_hessian_vs_nested_ad[iiwa14]
test_so_fused.py::test_hessian_full_fused_matches_bl
test_so_fused.py::test_hessian_vp_fused_matches_bl[barm]
test_so_fused.py::test_hessian_vp_fused_matches_bl[iiwa14]
test_so_md.py::test_md_full_hessian_contracts_to_vp
test_so_md.py::test_md_hessian_vp_matches_nested_ad[<lambda>-3]
test_so_md.py::test_md_hessian_vp_matches_nested_ad[<lambda>-7]
test_so_md.py::test_md_hessian_vp_reduces_to_fixed_base
test_so_md.py::test_md_id_hessian_vp_matches_nested_ad
test_so_staged.py::test_vp_staged_matches_bl_branched
test_so_staged.py::test_vp_staged_matches_bl_serial
test_so_staged.py::test_vp_staged_symmetric_and_zero_blocks
test_so_staged.py::test_vp_staged_xla_fallback_matches
test_softcontact.py::test_fused_interpret_matches_xla_soft
test_softcontact.py::test_md_fused_interpret_matches_xla_soft
test_softcontact.py::test_md_soft_zero_and_monotone
test_softcontact.py::test_soft_grad_flows
test_tendons.py::test_env_passive_spring_damps_knee
test_terrain.py::test_flat_terrain_equals_plane[0.0]
test_terrain.py::test_terrain_identification_gradient
test_welds.py::test_weld_end_to_end_from_mjcf
test_welds.py::test_weld_holds_relative_pose_through_contact
""".split())


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects by marker
def pytest_collection_modifyitems(session, config, items):
    # Where all of tests/ was collected without error, a listed id that is
    # not among the items is a typo or a renamed case.
    args = {(config.invocation_params.dir / a).resolve() for a in config.args}
    if args == {TESTS} and not session.testsfailed:
        missing = SLOW_CASES - {item.nodeid for item in items}
        assert not missing, f"SLOW_CASES names no collected test: {missing}"
    for item in items:
        if item.nodeid in SLOW_CASES or (
                _in_tests(item) and item.get_closest_marker("examples")):
            item.add_marker(pytest.mark.slow)
    # The sort is stable, so each group keeps its order.
    items.sort(key=lambda item: not (
        _in_tests(item) and item.path.name.startswith("test_torch_")))
