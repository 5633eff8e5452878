"""The control, the plain reference computed one precision below the
configuration's and put in the program's place, comes out not correct
under the limits while the program passes, at the tiny size on the CPU on
three seeds: ``calibrate.py --mode control`` for training (the tiny
training configuration is fp32, its control bf16) and the fp8 control
that ``calibrate.py`` reads beside the program for serving (bf16)."""

import json
import sys

import pytest

from benchmark.tests import tiny

SEEDS = ["11", "12", "13"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("control"))


def readings(root, capsys, *args):
    sys.path.insert(0, str(root))
    try:
        import importlib.util
        spec = importlib.util.spec_from_file_location("tiny_calibrate", root / "benchmark" / "calibrate.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.main(list(args) + ["--device", "cpu"]) == 0
    finally:
        sys.path.remove(str(root))
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_training_control_fails(root, capsys):
    limits = tiny.LIMITS["train"]
    rows = readings(root, capsys, "--workload", "tiny.train", "--seeds", *SEEDS, "--mode", "control")
    assert len(rows) == 3
    for r in rows:
        assert any(r[k] > v for k, v in limits.items()), r
    for r in readings(root, capsys, "--workload", "tiny.train", "--seeds", *SEEDS, "--mode", "program"):
        assert all(r[k] <= v for k, v in limits.items()), r


def test_serving_control_fails(root, capsys):
    # Only the control is held here: at this size one top-1 routing flip,
    # decided by the rounding order of a bf16 product (the thread count
    # changes it), moves the program's gap across the limit on some seeds.
    # test_layout holds the program's own run to the limit.
    (name, limit), = tiny.LIMITS["gen"].items()
    rows = readings(root, capsys, "--workload", "tiny.gen", "--seeds", *SEEDS, "--batches", "2")
    assert len(rows) == 3
    for r in rows:
        assert r["control"][name] > limit, r
