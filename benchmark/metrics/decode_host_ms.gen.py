"""decode_host_ms.gen: Milliseconds: median host duration of the sputnik.decode_step spans, the time the host
takes to issue one decode step.
"""

from benchmark import spans

START = spans.start()


def read(r):
    return spans.host_ms(START, "decode_step")
