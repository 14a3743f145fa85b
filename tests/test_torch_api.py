"""The port's public surface: the lazy secondary API the JAX package has, and
the device policy of its entry points (the card by default, never a silent
fall back to the CPU)."""

import inspect

import numpy as np
import pytest
import torch

import ppcseq_tpu_torch
from ppcseq_tpu_torch.infer import advi, diagnostics, hmc, nuts
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.pipeline import identify


def _gaussian(x):
    return -0.5 * x.pow(2).sum(1)


# entry point -> a call of it that leaves `device` at its default
_CALLS = {
    "fit_advi": (advi.fit_advi, lambda: advi.fit_advi(_gaussian, 2, torch.Generator(),
                                                      max_iter=100)),
    "vb_iterative": (advi.vb_iterative, lambda: advi.vb_iterative(_gaussian, 2, torch.Generator(),
                                                                  max_iter=100)),
    "run_hmc": (hmc.run_hmc, lambda: hmc.run_hmc(_gaussian, 2, torch.Generator(), num_chains=2,
                                                 num_warmup=1, num_draws=1, num_leapfrog=1)),
    "run_nuts": (nuts.run_nuts, lambda: nuts.run_nuts(_gaussian, 2, torch.Generator(),
                                                      num_chains=2, num_warmup=1, num_draws=1)),
    "prepare_data": (nb_model.prepare_data,
                     lambda: nb_model.prepare_data(np.ones((3, 2), dtype=np.int64),
                                                   np.ones((3, 1)), np.zeros(3), 1)),
    "do_inference": (identify.do_inference,
                     lambda: identify.do_inference(
                         None, "~ 1", "s", "t", "a", "c", approximate_posterior_inference=True,
                         approximate_posterior_analysis=True, X=None, sorted_sample_names=[],
                         exposure_by_sample={}, adj_prob_theshold=0.05,
                         how_many_posterior_draws=10, seed=0)),
}


@pytest.mark.parametrize("name", list(_CALLS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """`device` defaults to "cuda", and with no card the call raises before
    it computes anything, instead of running on the CPU."""
    fn, call = _CALLS[name]
    default = inspect.signature(fn).parameters.get("device")
    if default is None:  # vb_iterative passes its keywords on to fit_advi
        default = inspect.signature(advi.fit_advi).parameters["device"]
    assert default.default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        call()


@pytest.mark.parametrize("name,owner", [("run_hmc", hmc), ("run_nuts", nuts), ("fit_advi", advi),
                                        ("vb_iterative", advi), ("split_rhat", diagnostics),
                                        ("ess", diagnostics)])
def test_lazy_api_is_the_ports(name, owner):
    """ppcseq_tpu_torch.<name> is the port's own function, as
    ppcseq_tpu.<name> is the JAX package's."""
    assert getattr(ppcseq_tpu_torch, name) is getattr(owner, name)


def test_unported_and_unknown_names():
    """run_nuts is the port's sampler, sharded over a DeviceMesh since the
    mesh was ported (anything else as a mesh is a TypeError), and an unknown
    name is an AttributeError."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        ppcseq_tpu_torch.run_nuts(_gaussian, 2, torch.Generator(), mesh=object(), device="cpu")
    with pytest.raises(AttributeError, match="no_such_name"):
        ppcseq_tpu_torch.no_such_name  # noqa: B018
