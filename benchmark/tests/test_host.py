"""The host readings of a run: the sysfs cpulist parser, the placement note,
the check for JAX in ``sys.modules``, and the train driver's window at the
tiny size on the CPU with its step quartiles and the host line noted."""

import os
import sys
import time
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SEED = 2**31 + 515


@pytest.mark.parametrize("text,cpus", [
    ("0-31,64-95", set(range(32)) | set(range(64, 96))),
    ("7", {7}),
    ("7\n", {7}),
    ("", set()),
])
def test_parse_cpulist(text, cpus):
    assert harness.parse_cpulist(text) == cpus


def test_an_empty_cpulist_file_names_no_cpu(tmp_path):
    (tmp_path / "local_cpulist").write_text("")
    text = (tmp_path / "local_cpulist").read_text()
    assert harness.parse_cpulist(text) == set()
    assert harness.placement(text, "f") == "card local_cpulist empty (f)"


def test_placement_counts_the_local_cpus_in_the_affinity_and_changes_none():
    before = os.sched_getaffinity(0)
    assert harness.placement(None, "f") == "card local_cpulist missing (f)"
    far = max(before) + 4096
    assert harness.placement(f"{far}\n", "f") == f"card local_cpulist '{far}', 0 of its 1 CPUs in the affinity"
    text = ",".join(map(str, sorted(before))) + f",{far}"
    assert harness.placement(text, "f") == (f"card local_cpulist {text!r}, {len(before)} of its "
                                            f"{len(before) + 1} CPUs in the affinity")
    assert os.sched_getaffinity(0) == before


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    import sputnik_tpu_torch  # noqa: F401  (its name begins with the JAX package's)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert harness.forbidden_modules() == ["flax"]


def test_train_window_notes_its_steps_and_the_host(tmp_path, capsys):
    root = tiny.make(tmp_path)
    res = harness.run(root, "tiny.train", SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is True and all(c["value"] <= c["limit"] for c in res["checks"].values())
    err = capsys.readouterr().err
    assert "step s quartiles" in err and ", max " in err
    assert "a fixed Python loop took" in err and "ms after the window" in err
