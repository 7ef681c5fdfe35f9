"""zamba2_2_7b SMOKE trained on gloo meshes: two CPU ranks on ``(1, 2)``
and ``(2, 1)`` against one process, against the reference's jitted
sharded step and across checkpoints (``tests/torch_mesh_train.py`` holds
the body and states the tolerances).

Every LoRA ``b`` is drawn N(0, 0.5), not ``lora_init``'s zeros.  On
``(1, 2)`` each site's ``W + A @ B`` is cut to a model rank's block, so
the gradients of ``a`` (every projection) and of ``b`` (the row-parallel
``wo``) SUM over the model axis (``grad_lora``); the Mamba layers' per-
head scalars SUM as in mamba2, and the shared block, read by every
super-block, backs through each super-block's remat region.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_train as mt  # noqa: E402

mt.install(globals(), "hybrid")
