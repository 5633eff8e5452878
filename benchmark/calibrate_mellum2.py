"""Readings that set ``mellum2.complete``'s limit: the program's, the
control's (the plain reference one precision below the configuration's,
fp8 e4m3, in the program's place) and those of two faults planted under
the program, on many seeds in one process.

    python3 benchmark/calibrate_mellum2.py --seeds 1 2 3 --mode program
    python3 benchmark/calibrate_mellum2.py --seeds 1 2 3 --mode plain_rope_in_full_layers
    python3 benchmark/calibrate_mellum2.py --seeds 1 2 3 --mode window_at_whole_blocks

Each seed serves ``--batches`` batches of the cell's schedule, samples the
cell's ``check_requests`` as a run does and prints one JSON line: the
served tokens' gap statistics against the fp32 reference (``program``
also the control's on the same requests), the worst token and the
smallest top-k router margin at its position. These runs are not the
benchmark's.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def plain_rope_in_full_layers():
    """The full layers take the sliding layers' plain RoPE: no YaRN
    frequencies and no attention factor."""
    from sputnik_tpu_torch.models import transformer

    def make(tables):
        return lambda cfg, kind, *args: tables(cfg, "sliding" if kind == "full" else kind, *args)
    return _patched(transformer, "rope_tables", make)


@contextlib.contextmanager
def window_at_whole_blocks():
    """The sliding window cut at whole blocks: window / 128 key blocks up to
    the query's, with no token mask (prefill: the band of 8 blocks; decode:
    the keys from the start of the block 7 blocks back)."""
    from sputnik_tpu_torch.models import attention

    def prefill(attend):
        def wrapped(q, k, v, topology, *, window=0, **kw):
            if window:
                topology = attention.causal_block_topology(q.shape[-2], window_blocks=window // 128, dtype=q.dtype,
                                                           device=q.device)
            return attend(q, k, v, topology, **kw)
        return wrapped

    def decode(attend):
        def wrapped(q, k_cache, v_cache, pos, *, window=None, **kw):
            if window:
                window = pos % 128 + window - 127
            return attend(q, k_cache, v_cache, pos, window=window, **kw)
        return wrapped

    with _patched(attention, "multihead_block_sparse_attention", prefill), \
            _patched(attention, "decode_window_attention", decode):
        yield


FAULTS = {"plain_rope_in_full_layers": plain_rope_in_full_layers, "window_at_whole_blocks": window_at_whole_blocks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mellum2.complete")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", default="program", choices=["program"] + sorted(FAULTS))
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from benchmark import compare, harness, weights_mellum2
    from benchmark.drivers import serve, serve_mellum2
    from benchmark.reference import mellum2 as ref

    dev = torch.device(args.device)
    c = harness.cell(ROOT, args.workload)
    c.config = cfg = serve_mellum2.serving_config(c.config)
    tr = c.traffic
    tcfg = model = None
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.Context(cell=c, seed=seed, seconds=0.0, trace=False, device=dev, t_start=t)
        if model is None:
            tcfg, model = serve_mellum2.build(cfg, seed, dev)
        else:
            weights_mellum2.fill_module(model, cfg, seed)
        with FAULTS[args.mode]() if args.mode in FAULTS else contextlib.nullcontext():
            _, done = serve.serve(ctx, model, tcfg, units=args.batches)
        picked = serve.sample(ctx, done, tr["check_requests"])
        out_of = {i: out for i, _, _, out in done}
        tokens = [out_of[i][r] for i, r in picked]
        margins = []
        ref32, served = serve_mellum2.reference_logits(cfg, tr, seed, picked, tokens, dev, margins=margins)
        gaps = compare.token_gaps(ref32, served)
        line = {"workload": args.workload, "seed": seed, "mode": args.mode, "program": compare.gap_stats(gaps),
                "served_tokens": int(gaps.numel())}
        if args.mode == "program":
            low, _ = serve_mellum2.reference_logits(cfg, tr, seed, picked, tokens, dev,
                                                    precision=ref.control_precision(cfg))
            line["control"] = compare.gap_stats(compare.token_gaps(ref32, compare.argmax_tokens(low)))
            del low
        k = int(gaps.argmax())
        for (i, r), out, m in zip(picked, tokens, margins):
            tp = serve.schedule(tr, i)[0]
            if k < len(out):
                line["worst"] = {"batch": i, "row": r, "token": k, "gap": float(gaps.max()),
                                 "router_margin": float(m[tp - 1 + k]),
                                 "median_router_margin": float(m[tp - 1:].median())}
                break
            k -= len(out)
        del ref32
        harness.free(dev)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
