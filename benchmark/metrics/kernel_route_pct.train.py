"""kernel_route_pct.train: Percent: the port's dispatch.<op>.<variant> counters of cuda_* variants over all
dispatches in the traced window.
"""

from benchmark import spans

START = spans.start()


def read(r):
    return spans.kernel_route_pct(START)
