"""A run whose timed path is broken underneath comes out not correct,
once for each fault a served cell can have, at a tiny size on the CPU."""
import pytest

from portbench_paths import rehearse, workloads

import pb_faults
import portbench_rehearse


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_rehearse.checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("fault", sorted(pb_faults.FAULTS))
@pytest.mark.parametrize("workload", workloads())
def test_a_fault_makes_the_run_incorrect(root, workload, fault):
    rc, res, err = rehearse(root, workload, "--fault", fault,
                            "--seconds", "4")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
