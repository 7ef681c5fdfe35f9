"""seamless_m4t_medium SMOKE trained on gloo meshes: two CPU ranks on
``(1, 2)`` and ``(2, 1)`` against one process, against the reference's
jitted sharded step and across checkpoints (``tests/torch_mesh_train.py``
holds the body and states the tolerances).

The encoder, the decoder's self-attention and its cross-attention run on
each model rank's heads; every decoder layer's cross K/V projection
enters the encoder output, so its gradient SUMs over the model axis, and
the frames split with the rows on ``(2, 1)``.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_train as mt  # noqa: E402

mt.install(globals(), "encdec")
