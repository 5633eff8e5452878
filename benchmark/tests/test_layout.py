"""The harness is driven by data: a configuration, a traffic file, a limits
file and a metric placed in their folders are found by name, and a cell
built from them runs at a tiny size on the CPU through the drivers the
benchmark's own cells use. Nothing under ``benchmark/`` imports JAX or the
JAX package."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("layout"))
    # A metric of its own, found by its name in BENCHMARK.json.
    (root / "benchmark" / "metrics" / "tiny_calls.py").write_text(
        "RANGES = ['sputnik_tpu_torch.models.moe:moe_one']\n\n\n"
        "def read(r):\n    return float(len(r.ranges.of('moe.moe_one'))) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tiny_calls", "unit": "calls", "better": "higher", "source": "program_span",
                              "layer": "MoE FFN", "moves": "gen_tokens_per_s", "workloads": ["tiny.gen"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.gen", "tiny.prompt"])
def test_a_cell_runs_from_its_files(root, cell):
    res = harness.run(root, cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    c = harness.cell(root, cell)
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(c.limits)


def test_a_metric_file_is_found_by_name(root):
    res = harness.run(root, "tiny.gen", SEED, 0.5, True, torch.device("cpu"), time.perf_counter())
    # Two batches of two requests, with 12 and 16 new tokens: 11 + 15
    # decode steps, each through both layers.
    assert res["metrics"]["tiny_calls"]["value"] == (11 + 15) * 2
    # The CPU trace holds no device work: the device metrics are left out.
    assert "serve_mfu.gen" not in res["metrics"] and "busy_s" not in res["device"]


def test_traced_run_restores_the_port():
    from sputnik_tpu_torch.models import moe, transformer
    assert moe.moe_one.__name__ == "moe_one" and transformer.lm_prefill.__name__ == "lm_prefill"


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        mod = harness.metric_module(tiny.BENCH.parent, m["name"])
        assert callable(mod.read), m["name"]
    for w in spec["workloads"]:
        c = harness.cell(tiny.BENCH.parent, w["name"])
        assert (tiny.BENCH / "drivers" / f"{c.traffic['driver']}.py").exists()


def test_nothing_imports_jax_or_the_jax_package():
    for path in tiny.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "sputnik_tpu")]
        assert not bad, (path, bad)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"), "--workload", "moe-small.train", "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
