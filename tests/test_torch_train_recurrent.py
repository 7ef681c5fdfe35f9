"""Training on the CPU, the recurrent and encoder-decoder families (ssm
mamba2_1_3b, hybrid zamba2_2_7b, encdec seamless_m4t_medium at SMOKE):
the port's ``lm.train_loss``, its autograd gradients and one
``make_train_step`` step against the reference's
``jax.value_and_grad(lm.train_loss)`` and ``adamw_update``, run op by
op, once per family (``torch_train_parity.family_case``).  The hybrid's
train form folds each site's ``A @ B`` into the shared ``W``: its
gradients reach ``W``, ``A`` and ``B``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402

FAMILIES = ("ssm", "hybrid", "encdec")


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return tp.family_case(request.param)


def test_train_loss_matches_reference(case):
    total, mets, _ = tp.port_loss_and_grads(case)
    tp.check_loss(case, total, mets)


def test_train_grads_match_reference(case):
    _, _, grads = tp.port_loss_and_grads(case)
    tp.assert_grads_close(grads, case["jgrads"])
    if case["family"] == "hybrid":           # W, A and B all get gradient
        for name in ("wq", "wk", "wv", "wo"):
            for path in (f"/layers/shared/attn/{name}/w",
                         f"/layers/lora/{name}/a", f"/layers/lora/{name}/b"):
                assert np.abs(tp.f32(grads[path])).max() > 0, path
                assert np.abs(tp.f32(case["jgrads"][path])).max() > 0, path


def test_train_step_matches_reference(case):
    tp.check_step(case)
