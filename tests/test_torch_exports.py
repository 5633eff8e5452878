"""Every name the JAX package's ``__init__`` files export is exported by the
port's counterpart, except the named gaps below, each with its reason; and
every name in a port ``__all__`` resolves."""

import importlib

import pytest

PACKAGES = ["", ".models", ".ops", ".bench", ".utils", ".parallel", ".kernels"]

# Names of a JAX __all__ the port does not export yet, with the reason.
GAPS = {
    "": {
        "grad": "ROADMAP item 14: JAX needs it because jax.grad rejects int leaves; torch autograd does not",
        "value_and_grad": "ROADMAP item 14, as grad",
    },
    ".ops": {
        "grad": "ROADMAP item 14, as the package's grad",
        "value_and_grad": "ROADMAP item 14, as the package's grad",
    },
    ".models": {
        "moe_parallel": "ROADMAP item 13b: expert-parallel MoE",
        "init_block_params": "ROADMAP item 13b: the pipeline's per-stage parameters",
    },
    ".parallel": {name: "ROADMAP item 13b: the pipeline and the communication audit" for name in (
        "collective_bytes", "hlo_collectives", "pipeline_apply", "pipeline_train_step", "simulate_1f1b",
        "stack_stage_params")},
}
# Not in any JAX __all__, and not ported either: sputnik_tpu.ops's
# make_differentiable (ROADMAP item 14, as grad) and sputnik_tpu.native, a
# C++ extension with Python bindings, as a whole (item 14).


def _jax_all(sub):
    return importlib.import_module("sputnik_tpu" + sub).__all__


@pytest.mark.parametrize("sub", PACKAGES)
def test_port_exports_what_jax_exports(sub):
    port = importlib.import_module("sputnik_tpu_torch" + sub)
    assert hasattr(port, "__all__"), f"sputnik_tpu_torch{sub} has no __all__"
    gaps = GAPS.get(sub, {})
    missing = sorted(set(_jax_all(sub)) - set(port.__all__) - set(gaps))
    assert not missing, f"sputnik_tpu_torch{sub} lacks {missing}"
    stale = sorted(n for n in gaps if n in port.__all__ or n not in _jax_all(sub))
    assert not stale, f"gaps of sputnik_tpu_torch{sub} that are no longer gaps: {stale}"


@pytest.mark.parametrize("sub", PACKAGES)
def test_port_all_resolves(sub):
    port = importlib.import_module("sputnik_tpu_torch" + sub)
    unresolved = [n for n in port.__all__ if getattr(port, n, None) is None]
    assert not unresolved, f"sputnik_tpu_torch{sub}.__all__ names what it lacks: {unresolved}"


def test_named_entry_points_import():
    import sputnik_tpu_torch
    from sputnik_tpu_torch.models import decode_topk_attention, flash_block_attention, topk_block_topology  # noqa: F401
    from sputnik_tpu_torch.parallel import ring_block_sparse_attention  # noqa: F401
    from sputnik_tpu_torch.utils import testing

    assert sputnik_tpu_torch.prune.__name__ == "sputnik_tpu_torch.prune"
    assert testing.ATOL == 5e-2
