"""Faults planted in the program's timed path, to show that the comparison
catches them: each `plant(setattr)` replaces one function of the program
through `setattr(owner, name, value)` (pytest's monkeypatch.setattr in the
tests, `planted` on the card in control.py). The cells run on one chip, so
no exchange between chips can be left out.

- unchanged_step: an ADVI step that returns its parameters unchanged;
- half_the_samples: the likelihood (value and gradients) over the first
  half of the samples, scaled up by 2;
- half_the_samples_in_gradient: the same in the gradients alone;
- gradient_doubled, gradient_halved: the likelihood's gradients (K1's
  dalpha and dlog_phi) scaled by 2 or 1/2, its value left as it is;
- step_tenth: every Adam step a tenth as long;
- likelihood_tempered: the likelihood's value and gradients halved, a
  posterior over half the weight of the data;
- sampler_stuck: an HMC transition that never leaves its state (every
  proposal's energy change infinite);
- bound_altered: an upper credible bound doubled plus 5;
- call_altered: one deleterious-outlier call flipped.
"""

from __future__ import annotations

import contextlib
import dataclasses


def _likelihood(setattr, value_from, grads_from):
    """The likelihood's value and gradients each replaced by a function of
    (real, data, alpha, log_phi, want_grads)."""
    from ppcseq_tpu_torch.ops import nb_kernel

    real = nb_kernel._fast

    def fast(data, alpha, log_phi, want_grads):
        value = value_from(real, data, alpha, log_phi, want_grads)
        if not want_grads:
            return value
        _, dalpha, dlog_phi = grads_from(real, data, alpha, log_phi, want_grads)
        return value[0] if isinstance(value, tuple) else value, dalpha, dlog_phi

    setattr(nb_kernel, "_fast", fast)


def _sound(real, data, alpha, log_phi, want_grads):
    return real(data, alpha, log_phi, want_grads)


def _half(real, data, alpha, log_phi, want_grads):
    mask = data.like_mask.clone()
    mask[mask.shape[0] // 2:] = 0
    out = real(dataclasses.replace(data, like_mask=mask), alpha, log_phi, want_grads)
    return tuple(2 * o for o in out) if isinstance(out, tuple) else 2 * out


def _scaled(c):
    def grads(real, data, alpha, log_phi, want_grads):
        value, dalpha, dlog_phi = real(data, alpha, log_phi, want_grads)
        return value, c * dalpha, c * dlog_phi

    return grads


def unchanged_step(setattr):
    from ppcseq_tpu_torch.infer import advi

    real = advi.advi_step

    def step(params, state, eps, log_density, learning_rate):
        _, new_state, loss = real(params, state, eps, log_density, learning_rate)
        return params, new_state, loss

    setattr(advi, "advi_step", step)


def half_the_samples(setattr):
    _likelihood(setattr, _half, _half)


def half_the_samples_in_gradient(setattr):
    _likelihood(setattr, _sound, _half)


def gradient_doubled(setattr):
    _likelihood(setattr, _sound, _scaled(2.0))


def gradient_halved(setattr):
    _likelihood(setattr, _sound, _scaled(0.5))


def step_tenth(setattr):
    from ppcseq_tpu_torch.infer import advi

    real = advi.adam_scalars

    def scalars(count, learning_rate, dtype):
        bc1, bc2, step = real(count, learning_rate, dtype)
        return bc1, bc2, step * 0.1

    setattr(advi, "adam_scalars", scalars)


def likelihood_tempered(setattr):
    def halved(real, data, alpha, log_phi, want_grads):
        out = real(data, alpha, log_phi, want_grads)
        return tuple(0.5 * o for o in out) if isinstance(out, tuple) else 0.5 * out

    _likelihood(setattr, halved, halved)


def sampler_stuck(setattr):
    import torch

    from ppcseq_tpu_torch.infer import hmc

    real = hmc._energy_change

    def energy_change(*args, **kwargs):
        return torch.full_like(real(*args, **kwargs), float("inf"))

    setattr(hmc, "_energy_change", energy_change)


def bound_altered(setattr):
    from ppcseq_tpu_torch.pipeline import identify

    real = identify.approximated_ci

    def ci(*args, **kwargs):
        out = real(*args, **kwargs)
        out["upper"] = out["upper"] * 2 + 5
        return out

    setattr(identify, "approximated_ci", ci)


def call_altered(setattr):
    from ppcseq_tpu_torch.pipeline import identify

    real = identify.merge_results

    def merge(*args, **kwargs):
        out = real(*args, **kwargs)
        swd = out["sample_wise_data"].iloc[0]
        swd.loc[0, "deleterious_outliers"] = not bool(swd.loc[0, "deleterious_outliers"])
        return out

    setattr(identify, "merge_results", merge)


FAULTS = {f.__name__: f for f in (unchanged_step, half_the_samples,
                                  half_the_samples_in_gradient, gradient_doubled,
                                  gradient_halved, step_tenth, likelihood_tempered,
                                  sampler_stuck, bound_altered, call_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` planted for the duration of the block."""
    undo = []

    def put(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name](put)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
