"""The port's autotune cache, its registry routes and predicates, the
headline's tune pass and the roofline audit's row plan, against the JAX
package's, on the CPU.

* ``ops/autotune.py``: signatures (defaults dropped as in JAX), the cache
  round trip under ``tmp_path`` (``SPUTNIK_TPU_TORCH_TUNE_CACHE``), a cache
  of another version discarded, dispatch picking a cached winner and
  falling through when it cannot implement the problem, ``clear_cache``
  touching only its own card's key, and ``benchmark_variants`` /
  ``bench.dsd``'s tune pass with a patched timer (nothing is timed here).
* ``ops/matmul.py``: the ordered variant names per op equal JAX's (its
  names moved from ``pallas_`` to ``cuda_``), for the variants both have;
  the predicates of the variants this slice adds agree with JAX's on
  metadata known on the host (JAX: concrete) and built on the card (JAX:
  traced), inside and outside ``ACC_BUDGET`` / ``SDD_BRES_MAX_BYTES``, with
  ``ops.matmul._on_cuda`` patched as
  ``tests/test_torch_smallblock.py::test_first_fit_names_jax_route_on_cuda``
  does.
* ``bench/roofline.py``: the audit's rows at d = 256, in JAX's order, with
  JAX's flops / bytes / element-op models on the same inputs.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu_torch
from sputnik_tpu import ops as jops
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.bench import dsd as dsd_bench
from sputnik_tpu_torch.bench import roofline
from sputnik_tpu_torch.kernels import bsr_cres, bsr_sdd
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing

autotune = importlib.import_module("sputnik_tpu_torch.ops.autotune")
matmul_mod = importlib.import_module("sputnik_tpu_torch.ops.matmul")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 128


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty tune cache under ``tmp_path``."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("SPUTNIK_TPU_TORCH_TUNE_CACHE", str(path))
    autotune._reset()
    yield path
    autotune._reset()


def _operands(density=0.5, d=256):
    a = testing.random_bsr(np.random.default_rng(1), d, d, int(d * d * density), BS, device="cpu")
    return a, torch.from_numpy(np.random.default_rng(2).standard_normal((d, d)).astype(np.float32))


# -------------------------------------------------------------- autotune --
def test_signature_drops_defaults():
    """An explicit default keys as an absent one; a non-default kwarg, a
    dtype and another shape key apart; the card key is "cpu" here."""
    a, b = _operands()
    base = autotune._signature("dsd", (a, b), {})
    assert base.startswith("cpu|dsd|")
    assert autotune._signature("dsd", (a, b), {"transpose_a": False, "out_dtype": None, "plan": None}) == base
    assert autotune._signature("dsd", (a, b), {"transpose_a": True}) != base
    assert autotune._signature("dsd", (a, b), {"out_dtype": torch.bfloat16}) != base
    assert autotune._signature("dsd", (a, b), {"unknown": None}) == base
    assert autotune._signature("dsd", (a, b[:, :128]), {}) != base
    assert autotune._SIGNATURE_DEFAULTS == importlib.import_module("sputnik_tpu.ops.autotune")._SIGNATURE_DEFAULTS


def test_cache_round_trip_and_dispatch(cache):
    """A winner persisted by ``autotune(timings=)`` is read back by a fresh
    load, and dispatch picks it before first fit; ``variant=`` and
    ``forced_variant`` still win over it."""
    a, b = _operands()
    assert registry.dispatch_name("dsd", a, b) == "torch_reference"
    assert autotune.autotune("dsd", a, b, timings={"cuda_stream": 2.0, "jnp_fallback": 1.0}) == "jnp_fallback"
    raw = json.loads(cache.read_text())
    assert raw["version"] == sputnik_tpu_torch.__version__ and list(raw["entries"].values()) == ["jnp_fallback"]
    autotune._reset()  # a new process
    assert autotune.cached_variant("dsd", (a, b), {}) == "jnp_fallback"
    # jnp_fallback takes CUDA problems only: the cached winner cannot
    # implement this CPU problem, and dispatch falls through to first fit.
    assert registry.dispatch_name("dsd", a, b) == "torch_reference"
    autotune.autotune("dds", b, a, timings={"torch_reference": 1.0})
    assert registry.dispatch_name("dds", b, a) == "torch_reference"
    assert registry.dispatch_name("dds", b, a, variant="jnp_fallback") == "jnp_fallback"
    with registry.forced_variant("xla_dense_detour"):
        assert registry.dispatch_name("dds", b, a) == "xla_dense_detour"
    np.testing.assert_allclose(ops.matmul_dds(b, a).numpy(), (b @ a.to_dense()).numpy(), atol=1e-4, rtol=1e-5)


def test_cached_winner_is_dispatched(cache, monkeypatch):
    """A cached winner that can implement the problem is the one launched."""
    a, b = _operands()
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream"
    autotune.autotune("dsd", a, b, timings={"cuda_qstream_q2": 1.0, "cuda_stream": 2.0})
    assert registry.dispatch_name("dsd", a, b) == "cuda_qstream_q2"
    # Another problem keys apart and keeps first fit.
    a2, b2 = _operands(d=384)
    assert registry.dispatch_name("dsd", a2, b2) == "cuda_stream"


def test_empty_cache_computes_no_signature(cache, monkeypatch):
    """Untuned dispatch keeps its hot path: no signature is computed."""
    a, b = _operands()

    def boom(*_):
        raise AssertionError("a signature was computed")

    monkeypatch.setattr(autotune, "_signature", boom)
    monkeypatch.setattr(autotune, "_key", boom)
    assert registry.dispatch_name("dsd", a, b) == "torch_reference"


def test_cache_of_another_version_is_discarded(cache):
    a, b = _operands()
    key = autotune._signature("dsd", (a, b), {})
    cache.write_text(json.dumps({"version": "0.0.0-other", "entries": {key: "jnp_fallback"}}))
    assert autotune.cached_variant("dsd", (a, b), {}) is None
    cache.write_text(json.dumps({key: "jnp_fallback"}))  # a flat file of no version
    autotune._reset()
    assert autotune.cached_variant("dsd", (a, b), {}) is None
    cache.write_text(json.dumps({"version": sputnik_tpu_torch.__version__, "entries": {key: "jnp_fallback"}}))
    autotune._reset()
    assert autotune.cached_variant("dsd", (a, b), {}) == "jnp_fallback"


def test_clear_cache_touches_only_its_card(cache):
    """Here the card key is "cpu"; another card's entry stays."""
    a, b = _operands()
    other = "NVIDIA H100 80GB HBM3|dsd|x"
    cache.write_text(json.dumps({"version": sputnik_tpu_torch.__version__,
                                 "entries": {other: "cuda_stream", autotune._signature("dsd", (a, b), {}): "x"}}))
    autotune.clear_cache()
    assert json.loads(cache.read_text())["entries"] == {other: "cuda_stream"}
    autotune.clear_cache(all_chips=True)
    assert not cache.exists() and autotune.cached_variant("dsd", (a, b), {}) is None


def test_benchmark_variants_times_what_can_implement(cache, monkeypatch):
    """Every variant whose predicate takes the problem is timed, through a
    call that rebuilds the sparse operand from its data (the metadata
    closed over); a variant whose launch raises stops the tuning."""
    a, b = _operands()
    seen = []

    def fake_time(fn, *args, **_):
        seen.append(tuple(x.shape for x in args))
        out = fn(*args)
        assert torch.is_tensor(out)
        return {"time_s": 1e-3 * len(seen), "timing": "fake"}

    monkeypatch.setattr("sputnik_tpu_torch.utils.profiling.device_time", fake_time)
    timings = autotune.benchmark_variants("dsd", a, b)
    assert list(timings) == ["torch_reference"] and seen == [(tuple(a.data.shape), tuple(b.shape))]

    def boom(*_, **__):
        raise RuntimeError("launch failed")

    monkeypatch.setitem(registry._REGISTRY, "dsd",
                        registry._REGISTRY["dsd"] + [registry.KernelVariant("raises", lambda *x, **k: True, boom)])
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.benchmark_variants("dsd", a, b)
    monkeypatch.setitem(registry._REGISTRY, "dsd", registry._REGISTRY["dsd"][:-1])
    timings = autotune.benchmark_variants("dsd", a, b)
    takes = [v.name for v in registry.variants_for("dsd") if v.can_implement(a, b)]
    assert list(timings) == takes
    assert {"cuda_stream", "cuda_qstream", "cuda_cres", "cuda_gres"} <= set(timings)
    assert autotune.autotune("dsd", a, b) == min(timings, key=timings.get) == "cuda_stream"


def test_plain_variants_are_not_tuned_on_the_card(cache, monkeypatch):
    """For a problem on the card (the card key patched in), the plain
    variants are not timed, and a plain winner handed to ``autotune``
    raises and is not kept."""
    a, b = _operands()
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    monkeypatch.setattr(autotune, "_chip", lambda device: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr("sputnik_tpu_torch.utils.profiling.device_time",
                        lambda fn, *args, **_: {"time_s": 1e-3, "timing": "fake"})
    timings = autotune.benchmark_variants("dsd", a, b)
    assert "cuda_stream" in timings and not autotune.PLAIN_VARIANTS & set(timings)
    assert "jnp_fallback" in [v.name for v in registry.variants_for("dsd") if v.can_implement(a, b)]
    with pytest.raises(ValueError, match="plain variant jnp_fallback"):
        autotune.autotune("dsd", a, b, timings={"jnp_fallback": 1.0, "cuda_stream": 2.0})
    assert autotune.cached_variant("dsd", (a, b), {}) is None and not cache.exists()
    assert autotune.autotune("dsd", a, b, timings={"jnp_fallback": 3.0, "cuda_stream": 2.0}) == "cuda_stream"


def test_cache_is_read_once_per_process(cache, monkeypatch, tmp_path):
    """Dispatch reads the file once: a later change of the variable or of
    the file is seen only after ``_reset``. A lookup is remembered by its
    key tuple and forgotten when the cache changes."""
    a, b = _operands()
    key = autotune._signature("dsd", (a, b), {})
    assert autotune.cached_variant("dsd", (a, b), {}) is None
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"version": sputnik_tpu_torch.__version__, "entries": {key: "cuda_stream"}}))
    monkeypatch.setenv("SPUTNIK_TPU_TORCH_TUNE_CACHE", str(other))
    assert autotune.cached_variant("dsd", (a, b), {}) is None
    autotune._reset()
    assert autotune.cached_variant("dsd", (a, b), {}) == "cuda_stream"
    assert autotune._HOT == {autotune._key("dsd", (a, b), {}): "cuda_stream"}
    autotune.clear_cache()
    assert autotune._HOT == {} and autotune.cached_variant("dsd", (a, b), {}) is None


def test_tune_pass_persists_the_shortlist_winner(cache, monkeypatch, capsys):
    """``bench.dsd``'s tune pass times the shortlisted variants that can
    implement the problem, keeps the fastest and then answers from the
    cache; ``--no-tune`` is the first fit."""
    a, b = _operands()
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    times = {"cuda_stream": 3.0, "cuda_qstream": 1.0, "cuda_qstream_q2": 2.0, "cuda_gres": 4.0}
    timed = []

    def fake_time(fn, *args, **_):
        name = fake_time.current
        timed.append(name)
        return {"time_s": times[name], "timing": "fake"}

    real_variants = registry.variants_for("dsd")

    def variants_for(op):
        for v in real_variants:
            fake_time.current = v.name
            yield v

    monkeypatch.setattr(dsd_bench, "device_time", fake_time)
    monkeypatch.setattr(dsd_bench.ops.registry, "variants_for", variants_for)
    assert dsd_bench.tune_dsd(a, b) == "cuda_qstream"
    assert timed == list(dsd_bench.TUNE_SHORTLIST)
    assert "(tune: cuda_qstream 1000000.0 us/op)" in capsys.readouterr().err
    assert registry.dispatch_name("dsd", a, b) == "cuda_qstream"
    timed.clear()
    assert dsd_bench.tune_dsd(a, b) == "cuda_qstream" and not timed  # cached: nothing measured


def test_bench_py_shortlist_is_jax_names():
    """The shortlist is the root bench.py's, with the port's names."""
    src = open(os.path.join(ROOT, "bench.py")).read()
    jax_list = src.split("TUNE_SHORTLIST = (", 1)[1].split(")", 1)[0]
    names = [n.strip().strip('"') for n in jax_list.replace("\n", " ").split(",") if n.strip()]
    assert tuple(n.replace("pallas_", "cuda_") for n in names) == dsd_bench.TUNE_SHORTLIST


@pytest.mark.parametrize("module", ["roofline", "tune", "headline", "grid", "sss_floor", "flash_sweep"])
def test_new_entry_points_raise_without_a_card(module):
    """``python -m sputnik_tpu_torch.bench.<module>`` exits non-zero and
    prints no result on a machine without a CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", f"sputnik_tpu_torch.bench.{module}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr and not proc.stdout.strip()


# --------------------------------------------------------------- registry --
# The names both registries have: the port also registers cuda_bres_q4 on
# DDS and the CPU plain version, which JAX's has not.
def _common(jnames, tnames):
    mapped = [n.replace("pallas_", "cuda_") for n in jnames]
    return [n for n in mapped if n in tnames], [n for n in tnames if n in mapped]


# DDS's cres and gres follow the stream kernel on the H100 (ROADMAP.md,
# "Differences by design"); JAX registers them first.
_MOVED = {"dds": ("cuda_stream", ("cuda_cres", "cuda_gres"))}


@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
def test_variant_order_matches_jax(op):
    want, got = _common([v.name for v in jops.registry.variants_for(op)],
                        [v.name for v in registry.variants_for(op)])
    if op in _MOVED:
        after, moved = _MOVED[op]
        want = [n for n in want if n not in moved]
        i = want.index(after) + 1
        want[i:i] = list(moved)
    assert got == want
    new = {"dsd": {"cuda_qstream", "cuda_qstream_q2", "cuda_qstream_vacc", "cuda_qstream_kcat",
                   "cuda_qstream_kcat_q8", "cuda_cres", "cuda_gres", "cuda_cstack", "cuda_cstack_q4",
                   "xla_gather_bmm", "cuda_panel"},
           "dds": {"cuda_cres", "cuda_gres", "cuda_qstream", "cuda_ct", "cuda_qstream_vacc", "cuda_qstream_kcat",
                   "cuda_qstream_kcat_q8", "xla_gather_bmm", "cuda_stream_at", "cuda_panel"},
           "sdd": {"cuda_bres"}}[op]
    assert new <= set(got)


def _jax_pair(seed, rows, cols, n_blocks):
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, n_blocks * BS * BS, BS)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, n_blocks * BS * BS, BS, device="cpu")
    return jm, tm


def _jax_can(op, name, jargs, kw, traced):
    v = next(v for v in jops.registry.variants_for(op) if v.name == name)
    if not traced:
        return bool(v.can_implement(*jargs, **kw))
    out = []

    def trace(*args):
        out.append(bool(v.can_implement(*args, **kw)))
        return 0

    jax.make_jaxpr(trace)(*jargs)
    return out[0]


def _card_built(m):
    return dataclasses.replace(m, host_offsets=None, host_indices=None)


# (op, port name, JAX name) of this slice's variants.
NEW_VARIANTS = [("dsd", n, n.replace("cuda_", "pallas_")) for n in (
    "cuda_qstream", "cuda_qstream_q2", "cuda_qstream_vacc", "cuda_qstream_kcat", "cuda_qstream_kcat_q8", "cuda_cres",
    "cuda_gres")] + [("dds", n, n.replace("cuda_", "pallas_")) for n in (
        "cuda_cres", "cuda_gres", "cuda_qstream", "cuda_ct", "cuda_qstream_vacc", "cuda_qstream_kcat",
        "cuda_qstream_kcat_q8")] + [("sdd", "cuda_bres", "pallas_bres")]


@pytest.mark.parametrize("traced", [False, True], ids=["host", "card"])
@pytest.mark.parametrize("size", ["inside", "outside"])
@pytest.mark.parametrize("op,name,jname", NEW_VARIANTS)
def test_new_predicates_match_jax(monkeypatch, op, name, jname, size, traced):
    """The port's predicate takes the problem exactly when JAX's does; the
    dense operands are shape-only (``meta`` tensors, ``ShapeDtypeStruct``),
    so a problem past the budgets allocates nothing."""
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    d = 512 if size == "inside" else 2048
    wide = 512 if size == "inside" else 16384  # acc m * n * 4 > ACC_BUDGET; (m + n) * k * 4 > SDD_BRES_MAX_BYTES
    jsp, sp = _jax_pair(11, d, d, 3)
    if traced:
        sp = _card_built(sp)

    def dense(shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32), torch.empty(shape, device="meta")

    if op == "dsd":
        jb, b = dense((d, wide))
        jargs, targs = (jsp, jb), (sp, b)
    elif op == "dds":
        ja, a = dense((wide, d))
        jargs, targs = (ja, jsp), (a, sp)
    else:
        ja, a = dense((d, wide))
        jb, b = dense((wide, d))
        jargs, targs = (ja, jb, jsp), (a, b, sp)
    want = _jax_can(op, jname, jargs, {}, traced)
    got = next(v for v in registry.variants_for(op) if v.name == name).can_implement(*targs)
    assert got == want
    assert bsr_cres.ACC_BUDGET == 96 * 1024 * 1024 and bsr_sdd.SDD_BRES_MAX_BYTES == 96 << 20


# --------------------------------------------------------------- roofline --
def test_roofline_rows_match_jax(monkeypatch):
    """The audit's rows at d = 256 (no SSS row: its work list is empty
    there, as in JAX) in JAX's order, with JAX's models on the same inputs;
    JAX's audit runs with its timer patched, so nothing is timed."""
    jprof = importlib.import_module("sputnik_tpu.utils.profiling")
    monkeypatch.setattr(jprof, "device_time", lambda fn, *a, **k: {"time_s": 1.0, "timing": "fake"})
    jrows = importlib.import_module("sputnik_tpu.bench.roofline").audit(d=256, density=0.25)
    rows = roofline.row_plan(d=256, density=0.25, device="cpu")
    assert [r.op for r in rows] == [r["op"] for r in jrows]
    for j, r in zip(jrows, rows):
        assert (r.flops, r.bytes, r.vpu) == (j["flops"], j["bytes"], j["vpu_elems"]), r.op
    names = {r.op: r.variant() for r in rows if r.variant is not None}
    assert [r.op for r in rows if r.variant is None] == [
        "bsr_dsd_q8(stream)", "bsr_dsd_q8(bres)", "bsr_dds_q8(stream)", "bsr_softmax", "sdd_softmax(fused)",
        "csr_spmm(sell)", "csr_sddmm(sell)", "csr_softmax(sell)", "csr_spmm_t(sell)", "flash_block_attention",
        "flash_mha(8h)"]
    assert names["bsr_dds(ct)"] == "cuda_ct" and names["bsr_dsd(kcat_q8)"] == "cuda_qstream_kcat_q8"
    assert names["bsr_sdd(bres)"] == "cuda_bres" and names["bsr_ssd"] == "cuda_flat"


def test_roofline_names_a_row_by_the_kernels_it_launched(monkeypatch):
    """A row past the registry is named by the counts one call of it
    raises; a row that launches none of the audit's kernels is an error."""
    from sputnik_tpu_torch.kernels import bsr_softmax, sell

    def two_kernels():
        monkeypatch.setitem(sell.LAUNCHES, "sell_spmm", sell.LAUNCHES["sell_spmm"] + 1)
        monkeypatch.setitem(bsr_softmax.LAUNCHES, "sdd_softmax", bsr_softmax.LAUNCHES["sdd_softmax"] + 1)

    assert roofline.launched(roofline.Row("x", two_kernels, (), 1, 1)) == "sdd_softmax + sell_spmm"
    with pytest.raises(RuntimeError, match="launched none"):
        roofline.launched(roofline.Row("y", lambda: None, (), 1, 1))
