"""first_token_ms.prompt: Milliseconds: median over the traced requests of the device time from the start of
their sputnik.generate span to their first_token mark.
"""

from benchmark import spans

START = spans.start()


def read(r):
    return spans.first_token_ms(START)
