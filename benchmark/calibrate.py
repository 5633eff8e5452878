"""Readings that set a cell's limits: the program's, the control's and
planted faults', on many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --mode program
    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --mode control
    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --mode half_batch
    python3 benchmark/calibrate.py --workload <cell> --seeds 1 --mode sweep --rates 0.4 0.5 --seconds 20

Training: ``program`` runs the cell's first steps on the program and on the
fp32 reference; ``control`` puts the reference one precision below the
configuration's (fp8 for bf16) in the program's place;
a fault name plants that fault (``faults.py``) under the program. Serving:
``program`` serves ``--batches`` batches of the cell's schedule, samples
as a run does and reads the program's gap and the control's on the
same requests; ``sweep`` offers the cell's traffic at each of ``--rates``
batches a second for ``--seconds`` and reports the latency and how far
the last batch finished past the close (a backlog that grows means the
rate is above capacity). One JSON line per seed or rate; these runs are
not the benchmark's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import compare, faults, harness
    from benchmark.drivers import serve, train
    from benchmark.reference import model as ref

    dev = torch.device(args.device)
    c = harness.cell(ROOT, args.workload)
    cfg, tr = c.config, c.traffic
    model = None
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.Context(cell=c, seed=seed, seconds=0.0, trace=False, device=dev, t_start=t)
        line = {"workload": args.workload, "seed": seed, "mode": args.mode}
        if args.mode == "sweep":
            sweep(c, seed, dev, args.rates, args.seconds)
            continue
        if tr["driver"] == "train":
            if args.mode == "control":
                prog = train.reference_readings(cfg, tr, seed, dev, precision=ref.control_precision(cfg))
            else:
                fault = faults.FAULTS[args.mode]() if args.mode != "program" else faults.contextlib.nullcontext()
                with fault:
                    step, state, prog = train.program_readings(ctx, tr["reference_steps"])
                del step, state
            harness.free(dev)
            line.update(compare.train(prog, train.reference_readings(cfg, tr, seed, dev)))
            line["program_loss"] = prog["loss"]
        else:
            from sputnik_tpu_torch.models import transformer
            from benchmark import weights
            if model is None:
                tcfg = harness.transformer_config(cfg)
                model = transformer.SparseLM(tcfg, device=dev)
            weights.fill_module(model, cfg, seed)
            _, done = serve.serve(ctx, model, tcfg, units=args.batches)
            picked = serve.sample(ctx, done, tr["check_requests"])
            out_of = {i: out for i, _, _, out in done}
            tokens = [out_of[i][r] for i, r in picked]
            margins = []
            ref32, served = serve.reference_logits(cfg, tr, seed, picked, tokens, dev, margins=margins)
            low, _ = serve.reference_logits(cfg, tr, seed, picked, tokens, dev, precision=ref.control_precision(cfg))
            gaps = compare.token_gaps(ref32, served)
            line["program"] = compare.gap_stats(gaps)
            line["control"] = compare.gap_stats(compare.token_gaps(ref32, compare.argmax_tokens(low)))
            # The worst served token: its request, its row, and the smallest
            # router margin over the layers at the position that chose it.
            k = int(gaps.argmax())
            for (i, r), out, m, tp in zip(picked, tokens, margins, [serve.schedule(tr, i)[0] for i, _ in picked]):
                if k < len(out):
                    line["worst"] = {"batch": i, "row": r, "token": k, "gap": float(gaps.max()),
                                     "router_margin": float(m[tp - 1 + k]),
                                     "median_router_margin": float(m[tp - 1:].median())}
                    break
                k -= len(out)
            line["served_tokens"] = int(gaps.numel())
            del ref32, low
            harness.free(dev)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


def sweep(c, seed, dev, rates, seconds) -> None:
    import dataclasses
    import statistics
    from sputnik_tpu_torch.models import transformer
    from benchmark import harness, weights
    from benchmark.drivers import serve
    tcfg = harness.transformer_config(c.config)
    model = transformer.SparseLM(tcfg, device=dev)
    weights.fill_module(model, c.config, seed)
    ctx = harness.Context(cell=c, seed=seed, seconds=seconds, trace=False, device=dev, t_start=0.0)
    serve.serve(ctx, model, tcfg, units=2)  # warm-up
    for rate in rates:
        ctx = dataclasses.replace(ctx, cell=dataclasses.replace(c, traffic=dict(c.traffic, batches_per_s=rate)))
        t0, done = serve.serve(ctx, model, tcfg)
        lat = [(t - due) * 1e3 for _, due, t, _ in done]
        service = [(t - max(due, prev)) * 1e3 for (_, due, t, _), prev in
                   zip(done, [t0] + [t for _, _, t, _ in done[:-1]])]
        print(json.dumps({"workload": c.name, "rate": rate, "batches": len(done),
                          "latency_ms_p50": statistics.median(lat), "latency_ms_max": max(lat),
                          "latency_ms_first_half": statistics.mean(lat[: len(lat) // 2]),
                          "latency_ms_second_half": statistics.mean(lat[len(lat) // 2:]),
                          "service_ms_median": statistics.median(service),
                          "past_close_s": done[-1][2] - t0 - seconds}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
