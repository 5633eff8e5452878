"""A tiny benchmark tree for the CPU tests: the real ``BENCHMARK.json``
layout with one small configuration, traffic mixes and limits of its own,
placed by name in a copy of the benchmark's folders."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

TINY = {
    "name": "tiny-moe", "source": "tests", "d_model": 128, "n_layers": 2, "n_heads": 2, "d_head": 64,
    "n_experts": 4, "top_k": 1, "d_ff": 128, "activation": "gelu_tanh", "seq_len": 256, "vocab": 512,
    "global_batch_sequences": 2, "window_blocks": 1, "block_size": 128, "capacity": 128,
    "router_aux_weight": 0.01, "dtype": "bfloat16",
    "fp32_leaves": ["ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "lnf_scale", "lnf_bias", "moe.router"],
    "fused_attention": False, "reduced": [],
}
# Training at the tiny size is held in fp32, whose control (bf16) separates
# from the program there; at the tiny size bf16 rounding of the router's
# gradient reads as high as fp8's.
TINY32 = dict(TINY, name="tiny-moe32", dtype="float32")
# Serving in bf16 (control fp8) at a size where the two separate.
TINY_SERVE = dict(TINY, name="tiny-moe-serve", d_model=256, n_heads=4, n_experts=8, vocab=2048)
TRAIN = {"driver": "train", "lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8, "reference_steps": 3, "trace_units": 1}
GEN = {"driver": "serve", "batch": 2, "prompt_lens": [128, 256], "n_new": [12, 16], "max_len": 384, "mode": "band",
       "batches_per_s": None, "check_requests": None, "trace_units": 2}
PROMPT = dict(GEN, batches_per_s=50.0, n_new=[2], check_requests=4)
# Limits for the tiny sizes on the CPU, set between their readings on seeds
# 1-16. Training (fp32): the program's worst loss / grad / change gaps
# 1.1e-7 / 7.2e-7 / 4.5e-6, the bf16 control's least 1.8e-4 / 8.8e-3 /
# 9.9e-3. Serving (bf16, two batches, every request): the program's worst
# widest / mean logit gap 0.0154 / 3.8e-4, the fp8 control's least 0.065 /
# 3.1e-3. The generation cell compares the mean, the prompt cell the
# widest, as the benchmark's cells do.
LIMITS = {"train": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4},
          "gen": {"mean_logit_gap": 0.0012}, "prompt": {"logit_gap": 0.035}}


def make(tmp: Path) -> Path:
    """A root under ``tmp`` holding ``BENCHMARK.json`` and the benchmark's
    folders, with the tiny cells ``tiny.train``, ``tiny.gen`` and
    ``tiny.prompt``."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    spec["configs"] = []
    for cfg in (TINY32, TINY_SERVE):
        (b / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": cfg["name"], "source": "tests", "file": f"benchmark/configs/{cfg['name']}.json",
                                "reduced": [], "why": "tiny"})
    cells = {"tiny.train": ("tiny-moe32", "tiny-train", TRAIN, "train"),
             "tiny.gen": ("tiny-moe-serve", "tiny-gen", GEN, "gen"),
             "tiny.prompt": ("tiny-moe-serve", "tiny-prompt", PROMPT, "prompt")}
    spec["workloads"] = []
    for cell, (config, traffic, body, kind) in cells.items():
        (b / "traffic" / f"{traffic}.json").write_text(json.dumps(body))
        (b / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS[kind]))
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "tiny"})
    rename = {"moe-small.train": "tiny.train", "moe-medium.gen": "tiny.gen", "moe-medium.prompt": "tiny.prompt"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
