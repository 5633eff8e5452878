"""serve_mfu.complete: Percent of the bf16 peak: the traced window's useful operations (flops_mellum2.py: its
prefills and decode steps) over the window."""

from benchmark import flops_mellum2 as fm


def read(r):
    if r.profile is None or r.profile.window_s <= 0:
        return None
    useful = sum(fm.prefill(r.config, tp) for tp in r.work["prefill"]) + \
        sum(fm.decode_step(r.config, b, pos) for b, pos in r.work["decode"])
    return 100.0 * useful / (r.profile.window_s * fm.PEAK_BF16_FLOPS) if useful > 0 else None
