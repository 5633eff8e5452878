"""moe_backward_ms.train: Milliseconds: median over micro-batches of the summed device time of their
sputnik.moe.backward spans.
"""

from benchmark import spans

START = spans.start()


def read(r):
    return spans.backward_ms(START, "moe")
