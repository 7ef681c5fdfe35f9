"""The train step on the CPU: ``make_train_step`` (qwen3_4b SMOKE)
against the reference's run op by op at n_accum 1 and 2, remat against
no remat for all six families, gradient accumulation against one batch,
and a falling loss (the reference's ``test_loss_decreases``).

Tolerances are ``torch_train_parity``'s (LOSS_TOL, GRAD_TOL, STEP_TOL and
STEP_SHARE, stated there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.loop import TrainConfig, make_train_step  # noqa: E402

ARCH = "qwen3_4b"
ACCUMS = (1, 2)


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's ``make_train_step`` (unjitted, op by op) on SMOKE
    qwen3_4b, one step at each n_accum in ACCUMS, from the same weights
    and batch (2 rows of 17 tokens)."""
    jcfg = tp.jconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jmake_batch(0, 0, tp.BATCH, tp.SEQ, jcfg.vocab_size)
    out = {"np_params": jax.tree_util.tree_map(np.asarray, jparams)}
    for n in ACCUMS:
        tcfg = jloop.TrainConfig(optimizer=jadamw.AdamWConfig(lr=tp.LR),
                                 n_accum=n, wbits=tp.WBITS, abits=tp.ABITS)
        step, _ = jloop.make_train_step(tcfg, jcfg)
        with jax.disable_jit():
            opt = jadamw.adamw_init(jparams, tcfg.optimizer)
            new, new_opt, m = step(jparams, opt, batch)
        out[n] = (jax.tree_util.tree_map(np.asarray, new),
                  jax.tree_util.tree_map(np.asarray, new_opt),
                  {k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("n_accum", ACCUMS)
def test_train_step_matches_reference(reference_steps, n_accum):
    want_p, want_opt, want_m = reference_steps[n_accum]
    cfg = configs.get_smoke(ARCH)
    params = from_numpy_params(reference_steps["np_params"], device="cpu")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=tp.LR), n_accum=n_accum,
                       wbits=tp.WBITS, abits=tp.ABITS)
    step, _ = make_train_step(tcfg, cfg, device="cpu")
    batch = make_batch(0, 0, tp.BATCH, tp.SEQ, cfg.vocab_size)
    new, new_opt, m = step(params, adamw_init(params, tcfg.optimizer), batch)
    assert set(m) == set(want_m) == {"loss", "zloss", "moe_aux",
                                     "grad_norm", "clip"}
    for k in ("loss", "zloss"):
        assert abs(float(m[k]) - want_m[k]) <= tp.LOSS_TOL * want_m[k], k
    assert float(m["moe_aux"]) == want_m["moe_aux"] == 0.0
    for k in ("grad_norm", "clip"):
        assert abs(float(m[k]) - want_m[k]) <= tp.GRAD_TOL * want_m[k], k
    assert int(new_opt["step"]) == int(want_opt["step"]) == 1
    _assert_params_close(new, want_p)
    # the first moments: (1 - b1) x the clipped accumulated gradient
    for (k, g), (_, w) in zip(tp.leaves(new_opt["m"]),
                              tp.leaves(want_opt["m"])):
        scale = float(np.abs(tp.f32(w)).max()) or 1.0
        assert np.abs(tp.f32(g) - tp.f32(w)).max() <= tp.GRAD_TOL * scale, k


def _assert_params_close(got_tree, want_tree):
    got, want = dict(tp.leaves(got_tree)), dict(tp.leaves(want_tree))
    assert got.keys() == want.keys()
    n_diff = n_all = 0
    for k, w in want.items():
        w, g = tp.f32(w), tp.f32(got[k])
        diff = np.abs(g - w)
        one = np.spacing(np.maximum(np.abs(g), np.abs(w))) * (
            2.0 ** 16 if got[k].dtype == torch.bfloat16 else 1.0)
        assert (diff <= tp.STEP_TOL * tp.LR + one).all(), k
        n_diff += int((diff > 0).sum())
        n_all += diff.size
    assert n_diff <= tp.STEP_SHARE * n_all, (n_diff, n_all)


@pytest.mark.parametrize("family", tuple(tp.FAMILIES))
def test_remat_full_equals_none_bit_for_bit(family):
    """``remat="full"`` recomputes each layer (each super-block for the
    hybrid) in the backward pass: the same loss and gradients as
    ``remat="none"``, bit for bit."""
    base = configs.get_smoke(tp.FAMILIES[family])
    params = lm.init_params(base, torch.Generator().manual_seed(1),
                            device="cpu")
    batch = make_batch(3, 0, 2, 17, base.vocab_size, base)
    n = lm.n_bit_slots(base)
    wv = torch.tensor(tp.vec(tp.WBITS, n), dtype=torch.int32)
    av = torch.tensor(tp.vec(tp.ABITS, n), dtype=torch.int32)
    out = {}
    for remat in ("none", "full"):
        live = [p.detach().requires_grad_(True)
                for p in tp.tadamw.tree_leaves(params)]
        tree = tp.tadamw.tree_unflatten(params, live)
        total, _ = lm.train_loss(tree, batch, base.with_(remat=remat), wv, av)
        out[remat] = (total.detach(),
                      torch.autograd.grad(total, live, allow_unused=True))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def test_accumulation_equals_one_batch_without_quantizers():
    """4 microbatches against one batch of 4 rows.  The fake quantizers'
    activation scales are per tensor, so at 8 bits each microbatch
    quantizes on its own grid and the two steps differ by more than
    rounding (the reference's own 1-vs-4 test fails: ROADMAP Queue C).
    At 16 bits (the quantizers' identity) the mean of the 4 microbatch
    losses is the batch loss (every row has the same 32 targets), and
    the accumulated gradient differs from the batch's only by f32
    summation order and the bf16 rounding of each microbatch's
    gradient: the loss within LOSS_TOL, grad_norm within GRAD_TOL, and
    the new parameters as STEP_TOL and STEP_SHARE say."""
    cfg = configs.get_smoke(ARCH)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = make_batch(0, 0, 4, 33, cfg.vocab_size)
    runs = {}
    for n in (1, 4):
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=tp.LR), n_accum=n,
                           wbits=(16,), abits=(16,))
        step, _ = make_train_step(tcfg, cfg, device="cpu")
        runs[n] = step(params, adamw_init(params, tcfg.optimizer), batch)
    (p1, _, m1), (p4, _, m4) = runs[1], runs[4]
    assert abs(float(m4["loss"]) - float(m1["loss"])) \
        <= tp.LOSS_TOL * float(m1["loss"])
    assert abs(float(m4["grad_norm"]) - float(m1["grad_norm"])) \
        <= tp.GRAD_TOL * float(m1["grad_norm"])
    _assert_params_close(p4, tp.tadamw.tree_map(lambda t: t.float().numpy(),
                                                p1))


def test_loss_decreases():
    """The reference's test_loss_decreases: 8 steps at lr 1e-2 on batches
    of 4 x 33 tokens, and a drop of at least 0.1."""
    cfg = configs.get_smoke(ARCH)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2))
    step, _ = make_train_step(tcfg, cfg, device="cpu")
    opt = adamw_init(params, tcfg.optimizer)
    losses = []
    for i in range(8):
        params, opt, m = step(params, opt,
                              make_batch(0, i, 4, 33, cfg.vocab_size))
        losses.append(float(m["loss"]))
    assert int(opt["step"]) == 8
    assert losses[-1] < losses[0] - 0.1, losses
