"""The bf16 ``bsr_dsd_stream`` launch plan on the CPU: the tile, grid and
TMA boxes (``kernels/bsr_dsd.py::stream_plan``) are a pure function of the
shapes, and ``check_tma`` refuses what a TMA load cannot take. The kernel
itself (csrc/bsr_dsd.cu, TMA + wgmma) runs only on the card; its
agreement with the plain version is ``tests/test_torch_gpu.py``'s."""

import pytest

from sputnik_tpu_torch.kernels import bsr_dsd

MODES = [(False, False), (False, True), (True, False), (True, True)]


def _dsd_plan(m, n, batch, ta, tb):
    """C[M, N] = op(A_sparse) @ op(B): the kernel's tiles are C's."""
    return bsr_dsd.stream_plan(m // 128, n, batch, transpose_sparse=ta, transpose_dense=tb)


def _dds_plan(m, n, batch, ta, tb):
    """C[M, N] = op(A) @ op(B_sparse), run as C^T = op(B)^T @ op(A)^T: the
    kernel's block-rows are C's columns, its N is C's M (bsr_dsd.dds)."""
    return bsr_dsd.stream_plan(n // 128, m, batch, transpose_sparse=not tb, transpose_dense=not ta)


def _boxes(plan, ts, td):
    a = ((64, 64), plan.bm // 64) if ts else ((64, plan.bm), 1)
    b = ((64, plan.bn), 1) if td else ((64, 64), plan.bn // 64)
    return a, b


@pytest.mark.parametrize("t,grid_y", [(1024, 16), (2048, 32)])
@pytest.mark.parametrize("ta,tb", MODES)
def test_attention_shapes_take_64_row_tiles(t, grid_y, ta, tb):
    """8 heads x T / 128 block-rows x one 128-wide tile (N = d_head = 128)
    is under a wave of 132 SMs at 128 rows: BM 64 doubles the CTAs."""
    for plan in (_dsd_plan(t, 128, 8, ta, tb), _dds_plan(128, t, 8, ta, tb)):
        assert (plan.bm, plan.bn, plan.grid) == (64, 128, (1, grid_y, 8))
    plan = _dsd_plan(t, 128, 8, ta, tb)
    assert ((plan.a_box, plan.a_loads), (plan.b_box, plan.b_loads)) == _boxes(plan, ta, tb)
    plan = _dds_plan(128, t, 8, ta, tb)
    assert ((plan.a_box, plan.a_loads), (plan.b_box, plan.b_loads)) == _boxes(plan, not tb, not ta)


@pytest.mark.parametrize("ta,tb", MODES)
def test_headline_takes_128_by_256_tiles(ta, tb):
    """4096^2 at N = 4096: 1024 tiles of 128 x 128, 512 of 128 x 256."""
    cases = ((_dsd_plan(4096, 4096, 1, ta, tb), ta, tb), (_dds_plan(4096, 4096, 1, ta, tb), not tb, not ta))
    for plan, ts, td in cases:
        assert (plan.bm, plan.bn, plan.grid) == (128, 256, (16, 32, 1))
        assert ((plan.a_box, plan.a_loads), (plan.b_box, plan.b_loads)) == _boxes(plan, ts, td)


@pytest.mark.parametrize("m,n,batch,want", [
    (4096, 384, 1, (64, 128, (3, 64, 1))),    # 96 tiles: 64 rows; 384 is no multiple of 256
    (1024, 256, 2, (64, 128, (2, 16, 2))),    # the batch axis counts toward the wave
    (2048, 2048, 1, (128, 128, (16, 16, 1))),  # 256 tiles, but only 128 of 128 x 256
    (4096, 1024, 2, (128, 256, (4, 32, 2))),
    (1024, 1024, 24, (128, 256, (4, 8, 24))),
])
def test_tile_choice_follows_the_wave(m, n, batch, want):
    plan = _dsd_plan(m, n, batch, False, False)
    assert (plan.bm, plan.bn, plan.grid) == want


def test_check_tma_refuses_what_tma_cannot_load():
    ok = dict(sparse_data=(1 << 20, 256, 128 * 128 * 2 * 26), dense=(1 << 21, 128 * 2, 0))
    bsr_dsd.check_tma("bsr_dsd_stream", **ok)
    bad = [
        (dict(ok, dense=(1 << 21 | 8, 256, 0)), "dense address must be 16-byte aligned"),
        (dict(ok, sparse_data=(1 << 20 | 2, 256, 0)), "sparse_data address must be 16-byte aligned"),
        (dict(ok, dense=(1 << 21, 200, 0)), "dense row stride of 200 bytes"),
        (dict(ok, dense=(1 << 21, 256, 24)), "dense batch stride of 24 bytes"),
    ]
    for operands, match in bad:
        with pytest.raises(ValueError, match=match):
            bsr_dsd.check_tma("bsr_dsd_stream", **operands)
