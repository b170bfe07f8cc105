"""The port's lane sharding (``VMConfig.mesh``, ``autobatch(mesh=)``) against
the JAX package's ``mesh=2`` runs: the counterpart of tests/test_mesh.py.

Two ranks of a ``gloo`` process group, started once for the module by
``repro_torch.distributed.spawn`` on the CPU, run the whole matrix
(``tests/torch_mesh_workers.py``, which imports no JAX); the JAX side runs
here on two of tests/conftest.py's eight host devices.  ``fib`` is held
bit-exact under every schedule, with and without lane compaction, through
the stack groups' plain versions: outputs, ``steps``, ``block_exec``,
``block_active``, per-lane step counts and ``num_devices``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import ir as j_ir  # noqa: E402
from repro.core import lowering as j_lowering  # noqa: E402
from repro.core import pc_vm as j_pc_vm  # noqa: E402
from repro_torch import distributed  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import pc_vm as t_pc_vm  # noqa: E402
from tests import torch_mesh_workers as workers  # noqa: E402
from tests.test_core import FIB, build_fib  # noqa: E402

CELLS = [(s, ce) for s in t_pc_vm.SCHEDULES for ce in (None, 1)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of tests/torch_mesh_workers.py's matrix."""
    return distributed.spawn(workers.vm_matrix, 2, backend="gloo", devices=["cpu"] * 2,
                             rendezvous_dir=tmp_path_factory.mktemp("ranks"), timeout=300)


@pytest.fixture(scope="module")
def jax_fib():
    """The JAX VM on fib at the workers' batch, unsharded and over two
    devices, for every cell."""
    if jax.device_count() < 2:
        pytest.skip("needs >= 2 JAX devices (see tests/conftest.py)")
    low = j_lowering.lower(build_fib())
    inputs = {j_ir.qualify("fib", "n"): workers.fib_inputs()}
    out = {}
    for schedule, ce in CELLS:
        for mesh in (None, 2):
            res = j_pc_vm.ProgramCounterVM(low, j_pc_vm.VMConfig(
                batch_size=workers.FIB_Z, max_depth=24, schedule=schedule,
                compact_every=ce, mesh=mesh)).run(inputs)
            out[(schedule, ce, mesh)] = res
    return out


@pytest.mark.parametrize("schedule, ce", CELLS)
def test_fib_bit_exact_with_jax_sharded_and_unsharded(ranks, jax_fib, schedule, ce):
    want = FIB[workers.fib_inputs()]
    for mesh in (None, 2):
        j = jax_fib[(schedule, ce, mesh)]
        np.testing.assert_array_equal(np.asarray(j.outputs["fib/out"]), want)
    for r in ranks:
        got = r["fib"][(schedule, ce)]
        np.testing.assert_array_equal(got["out"], want, err_msg=f"rank {r['rank']}")
        assert got["converged"]


@pytest.mark.parametrize("schedule, ce", CELLS)
def test_steps_block_exec_and_num_devices_match_jax(ranks, jax_fib, schedule, ce):
    base, sharded = jax_fib[(schedule, ce, None)], jax_fib[(schedule, ce, 2)]
    assert sharded.sched.num_devices == 2
    for r in ranks:
        got = r["fib"][(schedule, ce)]
        assert got["steps"] == int(base.steps) == int(sharded.steps)
        np.testing.assert_array_equal(got["block_exec"], np.asarray(base.block_exec))
        np.testing.assert_array_equal(got["block_active"], np.asarray(base.block_active))
        np.testing.assert_array_equal(got["lane_steps"], np.asarray(base.lane_steps))
        assert got["num_devices"] == 2
        assert got["masked_updates"] == base.sched.masked_updates
        assert got["lane_occupancy"] == base.sched.mean_lane_occupancy
        if ce is None:
            # 8 lanes a rank: one tile each, as in the unsharded run.
            assert got["occupancy"] == base.sched.mean_occupancy


def test_output_is_a_dtensor_sharded_on_lanes(ranks):
    want = FIB[workers.fib_inputs()]
    for r in ranks:
        for cell in CELLS:
            got = r["fib"][cell]
            assert got["dtensor"] and got["mesh_dims"] == (t_pc_vm.LANE_AXIS,)
            np.testing.assert_array_equal(got["full"], want)
            assert (got["lanes"], got["offset"]) == (8, 8 * r["rank"])
            np.testing.assert_array_equal(got["local"], want[got["offset"]:][:8])


def test_dispatch_trace_sums_over_the_ranks(ranks):
    """The drained ring of a sharded run equals the unsharded run's, event
    for event (lane counts summed over the ranks).  The occupied tiles are
    left out: compaction packs each rank's lanes apart."""
    for r in ranks:
        sharded, plain = r["fib"]["trace"]
        assert sharded.keys() == plain.keys()
        assert plain["compacted"].any()
        for k in plain.keys() - {"tile_capacity"}:
            np.testing.assert_array_equal(sharded[k], plain[k], err_msg=k)


class TestResolveMesh:
    def test_none_passthrough(self, ranks):
        assert all(r["mesh"]["none"] == (True, True) for r in ranks)

    def test_int_builds_1d_mesh(self, ranks):
        assert all(r["mesh"]["one"] == ((t_pc_vm.LANE_AXIS,), 1, 1) for r in ranks)

    def test_explicit_mesh_passthrough(self, ranks):
        for r in ranks:
            assert r["mesh"]["explicit_passthrough"] and r["mesh"]["same_twice"]
            np.testing.assert_array_equal(r["mesh"]["explicit_run"], FIB[[5, 9, 2, 11]])

    def test_2d_mesh_rejected(self, ranks):
        assert all("ValueError" in r["mesh"]["two_d"] and "1-D mesh" in r["mesh"]["two_d"]
                   for r in ranks)

    def test_too_many_ranks(self, ranks):
        for r in ranks:
            assert r["mesh"]["too_many"].startswith("ValueError")
            assert "needs 3 ranks" in r["mesh"]["too_many"]

    def test_nonpositive(self, ranks):
        assert all(">= 1" in r["mesh"]["nonpositive"] for r in ranks)

    def test_mesh_smaller_than_the_world(self, ranks):
        """mesh=1 among two ranks: rank 0 runs alone, equal to the
        unsharded run; rank 1 is refused; neither hangs, and both still
        make the same groups after."""
        (out, devices, steps), agree0 = ranks[0]["mesh"]["smaller"]
        np.testing.assert_array_equal(out, FIB[[5, 9, 2, 11]])
        assert devices == 1 and steps > 0
        refused, agree1 = ranks[1]["mesh"]["smaller"]
        assert refused.startswith("ValueError") and "not in the mesh" in refused
        assert agree0 == agree1 == 2

    def test_cache_key_int_and_mesh_agree(self, ranks):
        for r in ranks:
            two, explicit, one = r["mesh"]["keys"]
            assert two == explicit == ((t_pc_vm.LANE_AXIS,), (0, 1))
            assert two != one

    def test_no_process_group_raises_and_names_how_to_start_ranks(self):
        """mesh=2 with no ranks is refused, never run on one device."""
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            t_pc_vm.resolve_mesh(2, "cpu")
        fn = t_batching.autobatch(workers.build_fib(), max_depth=24, mesh=2, device="cpu")
        with pytest.raises(ValueError, match="no torch.distributed process group"):
            fn(torch.arange(4, dtype=torch.int32))


class TestShardedVM:
    def test_indivisible_batch_rejected(self, ranks):
        assert all("divide" in r["mesh"]["indivisible"] for r in ranks)
        with pytest.raises(ValueError, match="divide"):
            t_pc_vm.ProgramCounterVM(t_batching.autobatch(workers.build_fib(), device="cpu")
                                     .lowered, t_pc_vm.VMConfig(batch_size=3, mesh=2), "cpu")

    def test_ranks_agree(self, ranks):
        """Every rank returns the whole batch, the same on each."""
        a, b = ranks
        assert (a["rank"], b["rank"], a["world"]) == (0, 1, 2)
        for cell in CELLS:
            for k in ("out", "lane_steps", "block_exec", "block_active"):
                np.testing.assert_array_equal(a["fib"][cell][k], b["fib"][cell][k])


class TestAutobatchMesh:
    def test_decorator_mesh_matches_unsharded(self, ranks):
        for r in ranks:
            sharded, plain, ndev = r["api"]["decorator"]
            np.testing.assert_array_equal(sharded, plain)
            np.testing.assert_array_equal(sharded, FIB[workers.fib_inputs(8)])
            assert ndev == 2

    def test_mesh_in_cache_key(self, ranks):
        for r in ranks:
            differs, key = r["api"]["cache_key"]
            assert differs and key == ((t_pc_vm.LANE_AXIS,), (0, 1))
            got, plain = r["api"]["double"]
            np.testing.assert_array_equal(got, plain)
            again, hits = r["api"]["double_again"]
            np.testing.assert_array_equal(again, plain)
            assert hits == 1

    def test_shared_args_and_pytree_outputs(self, ranks):
        for r in ranks:
            got, plain = r["api"]["shared"]
            np.testing.assert_array_equal(got, plain)
            np.testing.assert_array_equal(got, [0, 6, 9, 3])

    def test_aot_lower_waits_for_item_4(self):
        """The JAX test_aot_lower_and_cost_analysis's counterpart: lower()
        is ROADMAP item 4, with or without a mesh."""
        fn = t_batching.autobatch(workers.build_fib(), mesh=2, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
            fn.lower(np.arange(4, dtype=np.int32))

    def test_legacy_api_shim_passes_mesh(self, ranks):
        for r in ranks:
            got, warned, ndev = r["api"]["shim"]
            np.testing.assert_array_equal(got, FIB[[5, 9, 2, 11]])
            assert warned and ndev == 2

    def test_stack_overflow_still_raised_sharded(self, ranks):
        for r in ranks:
            message, lanes = r["api"]["overflow"]
            assert "max_depth" in message
            np.testing.assert_array_equal(lanes, [0])


def test_quarantine_mesh_cell(ranks):
    """tests/test_faults.py's test_quarantine_mesh_cell: every injected lane
    has its code and the healthy lanes are bit-exact, over two ranks."""
    for r in ranks:
        cell = r["chaos"]
        assert cell["ok"], cell["violations"]
        assert cell["faulted_lanes"] == 3


def test_stepper_segments_inject_and_park_match_the_unsharded_port(ranks):
    for r in ranks:
        sharded, plain = r["stepper"][2], r["stepper"][None]
        want = FIB[workers.fib_inputs(8)]
        for got in (sharded, plain):
            np.testing.assert_array_equal(got["whole"], want)
            np.testing.assert_array_equal(got["chained"], want)
        for k in ("refilled", "done", "codes", "lane_done", "steps"):
            np.testing.assert_array_equal(sharded[k], plain[k], err_msg=k)
        refilled = np.where(np.isin(np.arange(8), [1, 4, 6]), FIB[10], want)
        refilled[7] = 0  # parked before it produced its output
        np.testing.assert_array_equal(sharded["refilled"], refilled)
