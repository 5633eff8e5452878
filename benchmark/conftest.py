"""The benchmark's CPU tests build their tiny trees from
:mod:`benchmark.tests.tiny_source`: ``tiny.make`` knows only the MegaBlocks
cells' names."""

import pytest

from benchmark.tests import tiny, tiny_source


@pytest.fixture(scope="session", autouse=True)
def _tiny_source(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiny, "BENCH", tiny_source.source(tmp_path_factory.mktemp("bench_src")))
        yield
