"""A run whose timed path is broken underneath must come out not correct:
each fault of perfbench/faults.py that a cell can have, driven through the
cell's own loop and check on the CPU; and the control, the reference in
bfloat16 in the program's place, must fail the limits."""

import pytest
import torch

from perfbench import calibrate, harness

from .helpers import (SEED, TRAIN_LIMITS, is_train, run_small, small,
                      train_bench)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ["cornell-train", "bunny-train"])
def test_train_faults_fail(cell, fault):
    line = run_small(cell, fault=fault, size=16)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ["bunny-serve", "cornell-serve"])
def test_serve_faults_fail(cell, fault):
    line = run_small(cell, fault=fault, size=16, seconds=1.5)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_sharded_cell_on_four_gloo_ranks(fault):
    line = run_small("cornell-train-dp4", fault=fault, size=16, seconds=1.0)
    assert line["device"]["count"] == 4
    assert line["correct"] == (fault is None), line["checks"]


@pytest.mark.parametrize("cell", ["cornell-train", "bunny-train",
                                  "bunny-serve", "cornell-serve"])
def test_control_fails_the_limits(cell):
    if is_train(cell):
        limits, bench = TRAIN_LIMITS, train_bench()
        ov = dict(small(16), limits=limits)
    else:
        limits, bench = harness.cell_parts(harness.spec(), cell)[3], None
        ov = small(16)
    numbers = calibrate.control_reading(cell, SEED, torch.device("cpu"),
                                        ov, bench)
    assert any(numbers[k] > limits[k] for k in limits), numbers
