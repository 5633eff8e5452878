"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at the
tiny size on the CPU, once for each fault the cell can have (one chip: no
exchange between chips to leave out)."""

import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("faults"))


def run(root, cell):
    return harness.run(root, cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", "unchanged_step"),
    ("tiny.train", "half_batch"),
    ("tiny.gen", "altered_token"),
    ("tiny.gen", "half_served"),
    ("tiny.gen", "stale_cache"),
    ("tiny.prompt", "altered_token"),
    ("tiny.prompt", "half_served"),
])
def test_fault_is_not_correct(root, cell, fault):
    assert run(root, cell)["correct"] is True
    with faults.FAULTS[fault]():
        res = run(root, cell)
    assert res["correct"] is False, res["checks"]
