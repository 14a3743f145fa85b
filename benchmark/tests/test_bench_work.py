"""The frozen copy of the delta form's arithmetic equals the program's
`work("nb_glm_delta", ...)` at the shapes the program's kernel table
names: A (1, 21, 515) an ADVI step, E (100, 21, 515) its ELBO, H (128, 21,
515) an HMC leapfrog, V / W (1 / 100, 100, 50000) the 50k ADVI step / ELBO."""

from __future__ import annotations

import pytest

from benchmark.frozen.work import delta_work
from ppcseq_tpu_torch.ops import nb_kernel

SHAPES = {"A": (1, 21, 515), "E": (100, 21, 515), "H": (128, 21, 515),
          "V": (1, 100, 50000), "W": (100, 100, 50000)}


@pytest.mark.parametrize("grads", [True, False], ids=["grads", "value"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_frozen_work_is_the_programs(shape, grads):
    B, S, G = SHAPES[shape]
    for C in (1, 2, 3):
        assert delta_work(B, S, C, G, want_grads=grads) == nb_kernel.work(
            "nb_glm_delta", B, S, C, G, want_grads=grads)
