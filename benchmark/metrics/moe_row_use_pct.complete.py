"""moe_row_use_pct.complete: Percent: the port's counters moe.assignments (tokens x top-k) over
moe.rows_computed (the grouped GEMM's rows, each expert's group padded to whole row tiles) in the traced window."""

from benchmark import spans

START = spans.start()


def read(r):
    w = spans._window(START)
    if w is None or not w.counters.get("moe.rows_computed"):
        return None
    return 100.0 * w.counters.get("moe.assignments", 0) / w.counters["moe.rows_computed"]
