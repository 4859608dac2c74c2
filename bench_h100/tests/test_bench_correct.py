"""`correct` comes out false when the timed path is broken underneath, and
when the plain reference runs in the port's place in the precision below
the configuration's stated one; a sound run comes out true. The harness's
look for a chip is skipped: the runs go through `run_cell` on the CPU at a
tiny size (the port's kernels run their plain versions there)."""

import pytest
import torch

from bench_h100 import harness

TINY = {"points": 1000}


def run(workload, fault=None, control=False, device="cpu"):
    torch.manual_seed(0)
    return harness.run_cell(workload, 2**33 + 17, 0.2, False, device=device, overrides=TINY,
                            fault=fault, control=control, log=lambda msg: None)


@pytest.mark.parametrize("workload", ["tracking_hept.train", "tracking_hept_acc.eval"])
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def test_sound_run_compares_a_late_window_step():
    r = run("tracking_hept.train")
    assert {"window_loss_gap", "window_grad_gap", "window_update_gap"} <= set(r["checks"])
    # a number the cell's limits leave out is printed, not compared
    assert r["checks"]["first_loss_gap"]["limit"] is None and r["correct"]


@pytest.mark.parametrize("workload,fault", [
    ("tracking_hept.train", "frozen"),
    ("tracking_hept.train", "half_batch"),
    ("tracking_hept_acc.eval", "half_split"),
    ("tracking_hept_acc.eval", "altered"),
])
def test_fault_is_not_correct(workload, fault):
    r = run(workload, fault)
    assert not r["correct"], r["checks"]


def test_frozen_state_fails_the_window_step_too():
    r = run("tracking_hept.train", "frozen")
    assert r["checks"]["window_update_gap"]["value"] > r["checks"]["window_update_gap"]["limit"]


@pytest.mark.parametrize("workload", ["tracking_hept_acc.train", "tracking_hept_acc.eval"])
def test_e4m3_control_is_not_correct(workload):
    r = run(workload, control=True)
    limits = harness.cell_files(workload)["limits"]
    got = r["control"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
def test_tf32_control_is_not_correct(cuda_device):
    r = run("tracking_hept.train", control=True, device=cuda_device)
    limits = harness.cell_files("tracking_hept.train")["limits"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
