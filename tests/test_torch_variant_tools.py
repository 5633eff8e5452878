"""The port's variant tools (``bench/grid.py``, ``bench/grid_summary.py``,
``bench/sss_floor.py``, ``bench/headline.py``) against the JAX package's,
on the CPU.

Nothing is timed here: ``device_time`` is patched to one constant in both
packages, so the rows' time-derived fields (``gflops``, ``bound``,
``frac_sol``) compare the two packages' flops / bytes models and row
plans, JAX's run with the port's peaks. Variant names are not compared:
on the CPU the port dispatches to ``torch_reference``. ``grid_summary``
prints JAX's output character for character on the root
``bsr_grid_results.json`` (read only).
"""

import importlib
import os
import re
import sys

import pytest

from sputnik_tpu_torch.bench import grid, grid_summary, headline, sss_floor
from sputnik_tpu_torch.bench.models import PEAKS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE = {"time_s": 1e-4, "timing": "fake", "wall_s": 1e-4}


@pytest.fixture
def fake_timer(monkeypatch):
    """``device_time`` returns FAKE in both packages, calling nothing."""
    for mod in ("sputnik_tpu.utils.profiling", "sputnik_tpu_torch.utils.profiling"):
        monkeypatch.setattr(importlib.import_module(mod), "device_time", lambda fn, *a, **k: dict(FAKE))


def test_grid_summary_prints_jax_output(capsys, monkeypatch):
    path = os.path.join(ROOT, "bsr_grid_results.json")
    monkeypatch.setattr(sys, "argv", ["grid_summary", "--in", path])  # JAX's main reads sys.argv
    importlib.import_module("sputnik_tpu.bench.grid_summary").main()
    want = capsys.readouterr().out
    grid_summary.main(["--in", path])
    assert capsys.readouterr().out == want and "rows, sizes" in want


def test_grid_rows_match_jax(fake_timer):
    """``grid.run`` at d = 512 over JAX's default densities: the same rows in
    the same order, the same keys, and the same model-derived fields."""
    jrows = importlib.import_module("sputnik_tpu.bench.grid").run(512, [0.5, 0.25, 0.1], peaks=PEAKS)
    rows = grid.run(512, [0.5, 0.25, 0.1], device="cpu")
    assert len(rows) == len(jrows) == 6 * 4 * 3
    for j, r in zip(jrows, rows):
        assert (r["op"], r["mode"], r["d"], r["density"]) == (j["op"], j["mode"], j["d"], j["density"])
        assert list(r) == list(j), r["op"]
        assert r["bound"] == j["bound"] and r["timing"] == j["timing"] == "fake"
        for key in ("time_us", "gflops", "frac_sol"):
            assert r[key] == pytest.approx(j[key], rel=1e-12), (r["op"], r["mode"], key)


def test_sss_floor_plans_match_jax(fake_timer):
    """``sss_floor`` at d = 2048: JAX's n_items / n_steps per group (JAX
    times each group twice, kcat off and on; the port once)."""
    jrows = importlib.import_module("sputnik_tpu.bench.sss_floor").run(ds=(2048,))
    rows = sss_floor.run(ds=(2048,), device="cpu")
    assert [r["group"] for r in rows] == list(sss_floor.GROUPS)
    for r in rows:
        same = [j for j in jrows if j["group"] == r["group"]]
        assert len(same) == 2 and {j["kcat"] for j in same} == {False, True}
        assert all((j["n_items"], j["n_steps"]) == (r["n_items"], r["n_steps"]) for j in same)
        assert "kcat" not in r


def test_headline_extras_are_jax_names():
    """The extras are JAX's (names and knobs), less the documented ones."""
    src = open(os.path.join(ROOT, "sputnik_tpu", "bench", "headline.py")).read()
    block = src.split("extras = {", 1)[1].split("\n    }", 1)[0]
    jax_names = re.findall(r'"(\w+)": functools\.partial', block)
    omitted = [name for name, reason in headline.OMITTED_EXTRAS]
    assert all(reason for _, reason in headline.OMITTED_EXTRAS)
    assert omitted == ["qstream_q4_nt2048", "cstack_q8_nt4096", "cstack_q4_nt2048", "cstack_q8_nt1024"]
    assert list(headline.EXTRAS) == [n for n in jax_names if n not in omitted]
    for name, fn in headline.EXTRAS.items():
        knobs = dict(re.findall(r"(q|n_tile)=(\d+)", block.split(f'"{name}"', 1)[1].split('"', 1)[0]))
        assert {k: int(v) for k, v in knobs.items()} == fn.keywords, name
