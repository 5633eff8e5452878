"""The plain reference against the port at a tiny size on the CPU, both in
fp32: the loss and every leaf's gradient, the prefill's logits and the
decode steps' through the KV caches. The tiny configuration has a band
narrower than the sequence and two experts over 384 tokens, so capacity
drops happen in training and in prefill."""

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import model as ref
from benchmark.tests import tiny

CFG = dict(tiny.TINY, dtype="float32", n_experts=2, seq_len=384, vocab=256, window_blocks=2)
SEED = 2**31 + 7


@pytest.fixture(scope="module")
def port():
    from sputnik_tpu_torch.models import transformer
    tcfg = harness.transformer_config(CFG)
    model = transformer.SparseLM(tcfg, device="cpu")
    weights.fill_module(model, CFG, SEED)
    return transformer, tcfg, model


def ref_params():
    return {n: t.float().requires_grad_() for n, t in weights.draw_all(CFG, SEED, "cpu")}


def test_capacity_drops_happen():
    p = ref_params()
    x = ref.layernorm(p["embed"][torch.arange(384) % 256], p["blocks.0.ln2_scale"], p["blocks.0.ln2_bias"])
    _, expert = torch.softmax(x @ p["blocks.0.moe.router"], dim=-1).max(dim=-1)
    assert torch.bincount(expert, minlength=2).max() > CFG["capacity"]


def test_loss_and_gradients_match_the_port(port):
    transformer, tcfg, model = port
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, CFG["vocab"], (CFG["seq_len"],), generator=g)
    model.zero_grad()
    lo = transformer.lm_loss(model, tokens, tcfg, transformer.lm_topologies(tcfg, device="cpu"))
    lo.backward()
    p = ref_params()
    lr = ref.loss(p, tokens, CFG)
    lr.backward()
    assert float(lo.detach()) == pytest.approx(float(lr.detach()), rel=1e-5)
    for n, q in model.named_parameters():
        scale = p[n].grad.abs().max().clamp(min=1e-6)
        assert float((q.grad - p[n].grad).abs().max() / scale) < 1e-3, n


def test_prefill_and_decode_logits_match_the_port(port):
    transformer, tcfg, model = port
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, CFG["vocab"], (384,), generator=g)
    served = torch.randint(0, CFG["vocab"], (5,), generator=g)
    caches, logits = transformer.lm_prefill(model, prompt, tcfg, 512)
    rows = [logits]
    for i in range(len(served) - 1):
        lg, caches = transformer.lm_decode_step(model, served[i], caches, 384 + i, tcfg)
        rows.append(lg)
    got = torch.stack(rows)
    want = ref.served_logits(lambda n: weights.draw(CFG, SEED, n, "cpu"), CFG, [torch.cat([prompt, served])], [384])[0]
    assert want.shape == got.shape
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_fp8_control_differs_from_fp32():
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, CFG["vocab"], (CFG["seq_len"],), generator=g)
    p = ref_params()
    with torch.no_grad():
        lo32, lo8 = float(ref.loss(p, tokens, CFG)), float(ref.loss(p, tokens, CFG, "fp8"))
    assert lo32 != lo8 and abs(lo32 - lo8) < 0.1 * abs(lo32)


def test_adam_steps_are_torch_adam_with_fp32_storage():
    def batches(step):
        return [torch.randint(0, CFG["vocab"], (CFG["seq_len"],), generator=torch.Generator().manual_seed(step))]

    p = ref_params()
    q = {n: t.detach().clone().requires_grad_() for n, t in p.items()}
    losses, grad = ref.adam_steps(p, {n: torch.float32 for n in p}, batches, CFG, 2, 1e-3, (0.9, 0.999), 1e-8)
    opt = torch.optim.Adam(q.values(), lr=1e-3, foreach=False)
    for step in (1, 2):
        lo = ref.loss(q, batches(step)[0], CFG)
        lo.backward()
        if step == 1:
            assert grad == pytest.approx({n: float(t.grad.norm()) for n, t in q.items()}, rel=1e-5)
        opt.step()
        opt.zero_grad()
        assert losses[step - 1] == pytest.approx(float(lo.detach()), rel=1e-6)
    for n in p:
        assert torch.allclose(p[n].detach(), q[n].detach(), atol=1e-6, rtol=1e-5), n


def test_reference_imports_nothing_of_the_port():
    import ast
    src = (tiny.BENCH / "reference" / "model.py").read_text()
    names = [a.name for node in ast.walk(ast.parse(src)) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(ast.parse(src)) if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n.startswith(("sputnik_tpu", "jax", "benchmark"))]

