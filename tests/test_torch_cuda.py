"""The CUDA likelihood kernel against its plain torch version, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. They import
no JAX, so the card can run them without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops import nb_fast, nb_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(params=[1, 2, 3], ids=lambda c: f"C{c}")
def cuda_case(request):
    """Float32 model data on the card (one fully masked gene, ~5% excluded
    points) with C design columns, and B=5 parameter rows, from a numpy
    seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    S, G, C, B = 21, 300, request.param, 5
    X = np.column_stack([np.ones(S)] + [rng.integers(0, 2, S).astype(float) for _ in range(C - 1)])
    alpha_true = np.concatenate([rng.normal(4.0, 1.0, (1, G)), rng.normal(0.0, 0.5, (C - 1, G))])
    exposure = rng.normal(0.0, 0.3, S)
    counts = rng.poisson(np.minimum(np.exp(exposure[:, None] + X @ alpha_true), 1e6))
    exclude = rng.uniform(size=(S, G)) < 0.05
    exclude[:, 11] = True
    data, dims = nb_model.prepare_data(counts, X, exposure, 4, exclude_mask=exclude,
                                       device=dev, dtype=torch.float32)
    data = nb_model.with_baseline(data, dims)
    alpha = torch.as_tensor(alpha_true[None] + rng.normal(0, 0.1, (B, C, G)),
                            dtype=torch.float32, device=dev)
    log_phi = torch.as_tensor(rng.normal(0.0, 1.0, (B, G)), dtype=torch.float32, device=dev)
    return data, alpha, log_phi


def _plain(data, alpha, log_phi, want_grads=True):
    return nb_fast.glm_delta(
        data.X, data.counts, data.like_mask, data.alpha0, data.sigma_raw0, data.d0,
        data.sp_d0, data.sig_neg_d0, data.y_sp0, alpha, log_phi, want_grads,
    )


def test_kernel_matches_plain_version(cuda_case):
    """Value rtol 2e-5, gradient |d|/(1+|g|) < 1e-4, exactly zero gradients
    for the masked gene; one launch counted per call."""
    data, alpha, log_phi = cuda_case
    before = nb_kernel.LAUNCHES
    vk, dak, dlk = nb_kernel.launch(data.X, data.counts, data.like_mask, data.d0, alpha,
                                    data.alpha0, log_phi, data.sigma_raw0, want_grads=True)
    assert nb_kernel.LAUNCHES == before + 1
    vp, dap, dlp = _plain(data, alpha, log_phi)
    torch.cuda.synchronize()
    np.testing.assert_allclose(vk.cpu().numpy(), vp.cpu().numpy(), rtol=2e-5)
    for gk, gp in ((dak, dap), (dlk, dlp)):
        gp64 = gp.double().cpu().numpy()
        assert (np.abs(gk.double().cpu().numpy() - gp64) / (1 + np.abs(gp64))).max() < 1e-4
    assert torch.all(dak[:, :, 11] == 0) and torch.all(dlk[:, 11] == 0)


def test_autograd_and_value_only_paths_launch_the_kernel(cuda_case):
    data, alpha, log_phi = cuda_case
    a = alpha.clone().requires_grad_(True)
    before = nb_kernel.LAUNCHES
    value = nb_kernel.nb_glm_likelihood(data, a, log_phi)
    value.sum().backward()
    with torch.no_grad():
        v_only = nb_kernel.nb_glm_likelihood(data, alpha, log_phi)
    assert nb_kernel.LAUNCHES == before + 2
    _, dak, _ = nb_kernel.launch(data.X, data.counts, data.like_mask, data.d0, alpha,
                                 data.alpha0, log_phi, data.sigma_raw0, want_grads=True)
    torch.cuda.synchronize()
    assert torch.equal(a.grad, dak)
    np.testing.assert_allclose(v_only.cpu().numpy(), value.detach().cpu().numpy(), rtol=1e-6)


def test_kernel_refuses_wrong_dtype(cuda_case):
    data, alpha, log_phi = cuda_case
    with pytest.raises(TypeError, match="dtype"):
        nb_kernel.launch(data.X.double(), data.counts, data.like_mask, data.d0, alpha,
                         data.alpha0, log_phi, data.sigma_raw0, want_grads=False)
