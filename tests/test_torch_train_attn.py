"""Training on the CPU, the attention families (dense qwen3_4b, moe
moonshot_v1_16b_a3b, vlm internvl2_1b at SMOKE): the port's
``lm.train_loss``, its autograd gradients and one ``make_train_step``
step against the reference's ``jax.value_and_grad(lm.train_loss)`` and
``adamw_update``, run op by op.  The reference side runs once per family
(a module-scoped fixture, ``torch_train_parity.family_case``); the
tolerances are stated in ``torch_train_parity``.  The recurrent and
encoder-decoder families are in ``test_torch_train_recurrent.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402

FAMILIES = ("dense", "moe", "vlm")


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return tp.family_case(request.param)


def test_train_loss_matches_reference(case):
    total, mets, _ = tp.port_loss_and_grads(case)
    tp.check_loss(case, total, mets)


def test_train_grads_match_reference(case):
    _, _, grads = tp.port_loss_and_grads(case)
    tp.assert_grads_close(grads, case["jgrads"])


def test_train_step_matches_reference(case):
    tp.check_step(case)
