"""The port's benchmark tools against the JAX package's, on the CPU.

* The three probes of ``bench/mxu_probe.py`` (their plain versions on CPU
  tensors) against JAX's ``dense_stream`` / ``resident_stream`` /
  ``tiled_matmul`` in interpret mode on the same numpy inputs: fp32 at atol
  1e-4 / rtol 1e-5, bf16 (inputs scaled by 1/4) at the reference ATOL.
  ``accumulate=False`` leaves the last step's product in both.
* ``bench/models.py``'s flops and bytes exactly equal to JAX's for the same
  arguments.
* ``calibrate.load_measured_peaks`` refusing a garbled calibration or one
  taken on another card, the entry points raising without a card.
* The committed results under ``sputnik_tpu_torch/bench/results/``: each
  names a card and its power limit, and every fraction is at most 1.05, as
  ``tests/test_artifacts.py`` holds the JAX package's TPU records.

The CUDA probes are held against their plain versions on the card in
tests/test_torch_gpu.py.
"""

import glob
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.bench import models as jmodels
from sputnik_tpu.bench import mxu_probe as jprobe
from sputnik_tpu_torch.bench import calibrate, dsd, models, mxu_probe
from sputnik_tpu_torch.utils import profiling
from sputnik_tpu_torch.utils.testing import ATOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "sputnik_tpu_torch", "bench", "results")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(seed, m, k, n, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    scale = 1.0 if dtype_name == "float32" else 0.25
    a = rng.standard_normal((m, k)).astype(np.float32) * scale
    b = rng.standard_normal((k, n)).astype(np.float32) * scale
    return (jnp.asarray(a, jdt), jnp.asarray(b, jdt)), (torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))


def _close(got, want, dtype_name):
    tol = dict(atol=1e-4, rtol=1e-5) if dtype_name == "float32" else dict(atol=ATOL, rtol=0)
    assert got.dtype == DTYPES[dtype_name][1]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("accumulate", [True, False])
def test_dense_stream_matches_jax(dtype_name, accumulate):
    """Three steps of depth 128; without ``accumulate`` both keep only the
    last step's product, A[:, -128:] @ B[-128:, :]."""
    (ja, jb), (a, b) = _operands(0, 256, 384, 256, dtype_name)
    want = jprobe.dense_stream(ja, jb, depth=128, n_tile=128, accumulate=accumulate)
    got = mxu_probe.dense_stream(a, b, depth=128, accumulate=accumulate)
    _close(got, want, dtype_name)
    if not accumulate:
        _close(got, jnp.dot(ja[:, -128:], jb[-128:, :], preferred_element_type=jnp.float32), dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("mt", [128, 256])
def test_resident_stream_matches_jax(dtype_name, mt):
    (ja, jb), (a, b) = _operands(1, 256, 256, 128, dtype_name)
    want = jprobe.resident_stream(ja, jb, depth=128, mt=mt)
    _close(mxu_probe.resident_stream(a, b, depth=128, mt=mt), want, dtype_name)


@pytest.mark.parametrize("cfg", mxu_probe.SWEEP_CONFIGS)
def test_tiled_matmul_matches_jax(cfg):
    """Every tile of the port's sweep list, two k-steps of its depth."""
    bm, bk, bn = cfg
    (ja, jb), (a, b) = _operands(2, bm, 2 * bk, bn, "float32")
    _close(mxu_probe.tiled_matmul(a, b, bm=bm, bk=bk, bn=bn), jprobe.tiled_matmul(ja, jb, bm=bm, bk=bk, bn=bn),
           "float32")


def test_probes_refuse_what_the_kernels_do_not_take():
    a, b = torch.zeros(256, 256), torch.zeros(256, 256)
    with pytest.raises(ValueError, match=r"must be one of \(\(64, 32, 64\)"):
        mxu_probe.tiled_matmul(a, b, bm=512, bk=1024, bn=1024)
    with pytest.raises(ValueError, match="depth 96 must be a multiple of 32"):
        mxu_probe.dense_stream(a, b, depth=96)
    with pytest.raises(ValueError, match="mt=192"):
        mxu_probe.resident_stream(a, b, depth=128, mt=192)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        mxu_probe.dense_stream(a.to(torch.int8), b.to(torch.int8), depth=128)
    with pytest.raises(ValueError, match="needs both operands on one CUDA device"):
        mxu_probe._launch("mxu_tiled_matmul", a, b, 64, 32, 64)


MODEL_CASES = [
    ("dsd_model", dict(nnz=4 * 128 * 128 * 256, nnz_blocks=4 * 256, m=4096, n=4096, k=4096, isz=2,
                       touched_deps=32)),
    ("dsd_model", dict(nnz=300 * 16384, nnz_blocks=300, m=8192, n=8192, k=2048, isz=4, n_tile=2048)),
    ("dsd_model", dict(nnz=10 * 16384, nnz_blocks=10, m=2048, n=1024, k=2048, isz=1, n_tile=4096,
                       touched_deps=3)),
    ("sdd_model", dict(nnz=256 * 16384, nnz_blocks=256, m=2048, n=2048, k=2048, isz=2)),
    ("sdd_model", dict(nnz=40 * 16384, nnz_blocks=40, m=4096, n=2048, k=512, isz=4, touched_rows=9,
                       touched_cols=17)),
    ("sparse_out_flat_model", dict(total_items=1234, nnz_out=77 * 16384, isz=2)),
    ("dss_flat_model", dict(total_items=999, m=2048, n=4096, isz=4, bs=64)),
    ("softmax_model", dict(nnz=5 * 16384, isz=2)),
    ("sell_vpu_elems", dict(slots_total=12345, chunk=128)),
    ("sell_vpu_elems", dict(slots_total=77, chunk=64, tr=256, ops_per_slot=5)),
]


@pytest.mark.parametrize("name,kw", MODEL_CASES)
def test_models_equal_jax(name, kw):
    assert getattr(models, name)(**kw) == getattr(jmodels, name)(**kw)


def test_sol_time_is_the_larger_bound():
    """Without an element term both packages' sol_time is the larger of
    the two times at the peaks given; the element term uses the card's
    CUDA-core rate (132 SMs x 128 lanes x 1.98 GHz)."""
    kw = dict(peak_flops=989e12, hbm_bps=3.35e12)
    for flops, nbytes in ((34.4e9, 75e6), (1e6, 8e9)):
        assert models.sol_time(flops, nbytes, **kw) == jmodels.sol_time(flops, nbytes, **kw)
    assert models.VPU_ELEM_OPS == 132 * 128 * 1.98e9
    assert models.sol_time(0, 0, vpu_elems=int(1e12), **kw) == pytest.approx(1e12 / models.VPU_ELEM_OPS)
    assert models.PEAKS == {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bps": 3.35e12, "int8_ops": 1979e12}


@pytest.mark.parametrize("mxu,hbm,ok", [(0.7, 0.9, True), (0.0, 0.9, False), (1.2, 0.9, False), (0.7, 1.2, False),
                                        (1.05, 0.5, True), (-0.1, 0.5, False)])
def test_load_measured_peaks_refuses_garbled(tmp_path, monkeypatch, mxu, hbm, ok):
    monkeypatch.setattr(calibrate, "card", lambda: CARD)
    path = tmp_path / "peak.json"
    path.write_text(json.dumps({"mxu_efficiency": mxu, "hbm_efficiency": hbm, "card": CARD}))
    got = calibrate.load_measured_peaks(str(path))
    assert (got is not None) == ok
    assert calibrate.load_measured_peaks(str(tmp_path / "missing.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert calibrate.load_measured_peaks(str(tmp_path / "bad.json")) is None


@pytest.mark.parametrize("written_on,ok", [(CARD, True), ("NVIDIA H100 80GB HBM3, 500.00 W", False),
                                           ("NVIDIA A100-SXM4-80GB, 400.00 W", False), (None, False)])
def test_load_measured_peaks_refuses_another_card(tmp_path, monkeypatch, written_on, ok):
    """A calibration is used only on the card and power limit it was taken
    on; a file that names none is not used either."""
    monkeypatch.setattr(calibrate, "card", lambda: CARD)
    peak = {"mxu_efficiency": 0.7, "hbm_efficiency": 0.9}
    if written_on is not None:
        peak["card"] = written_on
    path = tmp_path / "peak.json"
    path.write_text(json.dumps(peak))
    assert (calibrate.load_measured_peaks(str(path)) is not None) == ok


def test_headline_metric_and_line():
    """The metric name is the root bench.py's; vs_machine_sol is left out
    without a calibration."""
    assert dsd.metric(4096, 0.25) == "bsr_dsd_spmm_bf16_d4096_density0.25"
    r = {"d": 4096, "density": 0.25, "gflops": 123456.789, "frac_sol": 0.123456}
    assert dsd.headline_line(r) == {"metric": "bsr_dsd_spmm_bf16_d4096_density0.25", "value": 123456.8,
                                    "unit": "GFLOP/s", "vs_baseline": 0.1235}
    assert dsd.headline_line({**r, "frac_machine_sol": 0.2})["vs_machine_sol"] == 0.2


def test_device_time_needs_a_card_and_a_known_mode():
    with pytest.raises(ValueError, match="perturb_mode"):
        profiling.device_time(torch.matmul, torch.zeros(2, 2), torch.zeros(2, 2), perturb_mode="shuffle")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            profiling.device_time(torch.matmul, torch.zeros(2, 2), torch.zeros(2, 2))


@pytest.mark.parametrize("module", ["dsd", "calibrate", "mxu_probe"])
def test_entry_points_raise_without_a_card(module):
    """``python -m sputnik_tpu_torch.bench.<module>`` exits non-zero and
    prints no result on a machine without a CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", f"sputnik_tpu_torch.bench.{module}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr and not proc.stdout.strip()


def _fractions(obj, key=""):
    """Every number under a key that names a fraction of a peak."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _fractions(v, k)
    elif isinstance(obj, list):
        for v in obj:
            yield from _fractions(v, key)
    elif isinstance(obj, (int, float)) and (key.startswith(("frac", "vs_")) or key.endswith("efficiency")):
        yield key, obj


@pytest.mark.parametrize("name", ["machine_peak", "mxu_probe", "tile_sweep", "bench_results", "headline_shootout",
                                  "bsr_grid_results", "sss_floor", "flash_sweep"])
def test_committed_results_name_the_card_and_stay_physical(name):
    with open(os.path.join(RESULTS, f"{name}.json")) as f:
        res = json.load(f)
    assert "H100" in res["card"] and res["card"].rstrip().endswith("W"), res["card"]
    fractions = list(_fractions(res))
    assert fractions
    for key, value in fractions:
        assert 0 < value <= 1.05, (name, key, value)


def test_results_directory_holds_only_card_records():
    """Every JSON file there names a card (none is a TPU record)."""
    for path in glob.glob(os.path.join(RESULTS, "*.json")):
        with open(path) as f:
            assert "card" in json.load(f), path
