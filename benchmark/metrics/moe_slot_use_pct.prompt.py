"""moe_slot_use_pct.prompt: Percent: the port's counters moe.tokens_kept over moe.slots_computed in the traced
window.
"""

from benchmark import spans

START = spans.start()


def read(r):
    return spans.slot_use_pct(START)
