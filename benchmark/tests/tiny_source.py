"""The benchmark as ``tiny.make`` reads it, with the names of cells that
have no tiny counterpart taken out of the metrics' ``workloads`` lists.

``tiny.make`` renames the three MegaBlocks cells in those lists to its tiny
cells and knows no other name; every other cell is dropped from the tiny
tree anyway. :func:`source` leaves the benchmark's folders as they are and
writes the filtered ``BENCHMARK.json`` beside a link to them, so that
``tiny.BENCH`` can point there."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.tests import tiny

TINY_CELLS = ("moe-small.train", "moe-medium.gen", "moe-medium.prompt")


def source(tmp: Path) -> Path:
    """The folder to stand as ``tiny.BENCH``: under ``tmp``, a link to the
    benchmark's folder beside a ``BENCHMARK.json`` whose metrics list only
    the cells in :data:`TINY_CELLS`."""
    spec = json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in TINY_CELLS]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (tmp / "benchmark").symlink_to(tiny.BENCH, target_is_directory=True)
    return tmp / "benchmark"
