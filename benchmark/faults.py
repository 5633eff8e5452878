"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false and for the calibration of the limits. Each is
a context manager that patches the port and undoes the patch."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged_step():
    """Every optimizer step returns the state unchanged."""
    return _patched(torch.optim.Adam, "step", lambda step: lambda self, closure=None: None)


def half_batch():
    """Half of each step's sequences left out, the mean taken over the
    rest: every second ``lm_loss`` counts twice, the others not at all."""
    from sputnik_tpu_torch.models import transformer
    count = [0]

    def make(lm_loss):
        def wrapped(*args, **kwargs):
            count[0] += 1
            return lm_loss(*args, **kwargs) * (2.0 if count[0] % 2 else 0.0)
        return wrapped
    return _patched(transformer, "lm_loss", make)


def altered_token():
    """One served token altered where it is produced: the decode loop's
    third step picks the next token id after the argmax."""
    from sputnik_tpu_torch.models import transformer
    count = [0]

    def make(sample_tokens):
        def wrapped(logits, *args, **kwargs):
            tok = sample_tokens(logits, *args, **kwargs)
            count[0] += 1
            return (tok + 1) % logits.shape[-1] if count[0] % 3 == 0 else tok
        return wrapped
    return _patched(transformer, "sample_tokens", make)


def half_served():
    """Half of each batch left out: the first half of the prompts is
    served and its answers are returned for the whole batch."""
    from sputnik_tpu_torch.models import transformer

    def make(generate):
        def wrapped(model, prompts, *args, **kwargs):
            half = max(1, prompts.shape[0] // 2)
            out = generate(model, prompts[:half], *args, **kwargs)
            return out.repeat((prompts.shape[0] + half - 1) // half, 1)[: prompts.shape[0]]
        return wrapped
    return _patched(transformer, "lm_generate_batched", make)


def stale_cache():
    """Each decode step returns the caches unchanged: the step works on
    copies and its writes are lost."""
    from sputnik_tpu_torch.models import transformer

    def make(step):
        def wrapped(params, token, caches, *args, **kwargs):
            logits, _ = step(params, token, [{k: v.clone() for k, v in c.items()} for c in caches], *args, **kwargs)
            return logits, caches
        return wrapped
    return _patched(transformer, "lm_decode_step", make)


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch, "altered_token": altered_token,
          "half_served": half_served, "stale_cache": stale_cache}
