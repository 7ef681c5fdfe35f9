"""Shared fixtures of the training parity tests (``test_torch_train_*``):
one family's SMOKE weights, batch and bit vectors in both packages, and
the reference's ``value_and_grad(lm.train_loss)`` run op by op
(``jax.disable_jit``), computed once per family.

Tolerances, stated once for every family:

* LOSS_TOL — the port's loss (and z-loss, MoE aux) relative to the
  reference's.  Both compute the same f32 ops on the same bf16 weights;
  only summation orders differ (measured: at most 8e-8).
* GRAD_TOL — each gradient leaf, max |port - reference| over the leaf's
  largest reference magnitude.  Gradients of bf16 leaves are bf16
  (relative spacing 2^-8 = 3.9e-3), and their f32 partial sums run in
  other orders, so an element may land one or two bf16 steps apart
  (measured: at most 7.3e-3, the encdec encoder's norm scale).
* STEP_TOL, STEP_SHARE — after one AdamW step (lr LR) each new
  parameter element is within 2 LR + one bf16 step of its value of the
  reference's, and at most STEP_SHARE of all elements differ at all.
  Adam's first update is about ``g / |g|`` per element, so an element
  whose gradient lies within GRAD_TOL of 0 may move 2 LR the other way,
  and its new value may then round to the next bf16 (a step at the
  larger of the two values); elsewhere the
  updates agree to f32 and round to the same bf16 (measured: 0 of
  106880 elements differ for dense, 131 of 167088 for the hybrid).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import make_batch as tmake_batch
from repro_torch.models.convert import from_numpy_params
from repro_torch.optim import adamw as tadamw

LOSS_TOL = 1e-5
GRAD_TOL = 2e-2
STEP_TOL = 2.0            # x LR, plus one bf16 step of the value
STEP_SHARE = 2e-3
LR = 1e-3
WBITS, ABITS = (8, 4), (8,)           # slot 0 at 8 bits, the rest at 4
BATCH, SEQ = 2, 17                    # 16 inputs and 16 targets a row
FAMILIES = {"dense": "qwen3_4b", "moe": "moonshot_v1_16b_a3b",
            "vlm": "internvl2_1b", "ssm": "mamba2_1_3b",
            "hybrid": "zamba2_2_7b", "encdec": "seamless_m4t_medium"}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def vec(table, n):
    return [table[min(i, len(table) - 1)] for i in range(n)]


def family_case(family: str) -> dict:
    """One family's SMOKE parameters (the reference's draws, bridged), a
    batch from each package's ``make_batch`` (asserted equal), and the
    reference's loss, metrics and gradients op by op.  The hybrid's LoRA
    ``b`` (zeros at init) is redrawn from a seed in both, so the gradient
    of ``a`` is not zero."""
    arch = FAMILIES[family]
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    if family == "hybrid":
        rng = np.random.default_rng(5)
        for pair in np_params["layers"]["lora"].values():
            b = rng.standard_normal(pair["b"].shape) * 0.05
            pair["b"] = np.asarray(jnp.asarray(b, jnp.bfloat16))
        jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    n = jlm.n_bit_slots(jcfg)
    wv, av = vec(WBITS, n), vec(ABITS, n)
    jbatch = jmake_batch(0, 0, BATCH, SEQ, jcfg.vocab_size, jcfg)
    tbatch = tmake_batch(0, 0, BATCH, SEQ, tcfg.vocab_size, tcfg)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(f32(tbatch[k]), f32(v))
    with jax.disable_jit():
        (jtotal, jmets), jgrads = jax.value_and_grad(
            jlm.train_loss, has_aux=True)(
                jparams, jbatch, jcfg, jnp.asarray(wv, jnp.int32),
                jnp.asarray(av, jnp.int32))
    return {"family": family, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jparams, "np_params": np_params,
            "tparams": from_numpy_params(np_params, device="cpu"),
            "jbatch": jbatch, "tbatch": tbatch, "wv": wv, "av": av,
            "jtotal": float(jtotal),
            "jmets": {k: float(v) for k, v in jmets.items()},
            "jgrads": dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                         jgrads)))}


def port_loss_and_grads(case):
    """The port's train_loss and autograd gradients on the bridged
    parameters: (total, metrics, {path: grad})."""
    from repro_torch.models import lm as tlm
    named = dict(leaves(case["tparams"]))
    live = {k: v.detach().requires_grad_(True) for k, v in named.items()}
    it = iter(live.values())
    tree = tadamw.tree_unflatten(case["tparams"], list(it))
    total, mets = tlm.train_loss(
        tree, case["tbatch"], case["tcfg"],
        torch.tensor(case["wv"], dtype=torch.int32),
        torch.tensor(case["av"], dtype=torch.int32))
    grads = torch.autograd.grad(total, list(live.values()),
                                allow_unused=True)
    return total, mets, dict(zip(live, grads))


def assert_grads_close(got: dict, want: dict, tol: float = GRAD_TOL):
    """Each leaf within ``tol`` x its largest reference magnitude; the
    failure names the worst leaf and element."""
    assert got.keys() == want.keys()
    worst = (0.0, None, None)
    for k, w in want.items():
        w = f32(w)
        g = np.zeros_like(w) if got[k] is None else f32(got[k])
        assert g.shape == w.shape, k
        scale = float(np.abs(w).max()) or 1.0
        err = np.abs(g - w) / scale
        i = np.unravel_index(int(np.argmax(err)), err.shape)
        if err[i] > worst[0]:
            worst = (float(err[i]), k, (i, float(g[i]), float(w[i]), scale))
    assert worst[0] <= tol, (
        f"gradient leaf {worst[1]}: element {worst[2][0]} port "
        f"{worst[2][1]!r} reference {worst[2][2]!r}, |diff| / max|ref| = "
        f"{worst[0]:.3g} (max|ref| {worst[2][3]!r}) > {tol}")


def reference_step(case, ocfg):
    """The reference's n_accum=1 step from the case's own gradients: its
    train_step accumulates ``0 + g.astype(f32) / 1`` (exactly g) and
    calls ``adamw_update``, run here op by op."""
    grads = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32),
                                   _unflat(case["jgrads"]))
    with jax.disable_jit():
        opt = jadamw.adamw_init(case["jparams"], ocfg)
        return jadamw.adamw_update(case["jparams"], grads, opt, ocfg)


def _unflat(flat: dict):
    out: dict = {}
    for path, v in flat.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)
    return out


def check_loss(case, total, mets):
    """The total and each metric within LOSS_TOL of the reference's
    (relative; moe_aux is exactly 0 off the moe family in both)."""
    got = {"total": float(total.detach()),
           **{k: float(v.detach()) for k, v in mets.items()}}
    want = {"total": case["jtotal"], **case["jmets"]}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_TOL * abs(w), (k, got[k], w)
    assert (want["moe_aux"] > 0) == (case["family"] == "moe")


def check_step(case):
    """One port ``make_train_step`` step (n_accum 1, AdamW at LR) against
    the reference's from the same gradients: the new parameters as
    STEP_TOL and STEP_SHARE say, ``grad_norm`` and ``clip`` within
    GRAD_TOL (relative), ``step`` 1, the step's loss within LOSS_TOL,
    and the caller's tensors unchanged and outside any graph."""
    from repro_torch.train.loop import TrainConfig, make_train_step
    jnew, _, jm = reference_step(case, jadamw.AdamWConfig(lr=LR))
    tcfg = TrainConfig(optimizer=tadamw.AdamWConfig(lr=LR), n_accum=1,
                       wbits=WBITS, abits=ABITS)
    step, (wvec, avec) = make_train_step(tcfg, case["tcfg"], device="cpu")
    assert wvec.tolist() == case["wv"] and avec.tolist() == case["av"]
    params = case["tparams"]
    new, new_opt, m = step(params, tadamw.adamw_init(params, tcfg.optimizer),
                           case["tbatch"])
    assert int(new_opt["step"]) == 1 and new_opt["step"].dtype == torch.int32
    want_loss = case["jmets"]["loss"]
    assert abs(float(m["loss"]) - want_loss) <= LOSS_TOL * want_loss
    for k in ("grad_norm", "clip"):
        assert abs(float(m[k]) - float(jm[k])) <= GRAD_TOL * float(jm[k]), k
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, jnew)))
    got, before = dict(leaves(new)), dict(leaves(params))
    assert got.keys() == want.keys()
    n_diff = n_all = 0
    for k, w in want.items():
        assert got[k].dtype == before[k].dtype, k
        w, g = f32(w), f32(got[k])
        diff = np.abs(g - w)
        # one step of the dtype at the larger value: each side rounds by
        # half a step of its own binade
        one = np.spacing(np.maximum(np.abs(g), np.abs(w))) * (
            2.0 ** 16 if got[k].dtype == torch.bfloat16 else 1.0)
        bound = STEP_TOL * LR + one
        i = np.unravel_index(int(np.argmax(diff - bound)), diff.shape)
        assert diff[i] <= bound[i], (
            f"{k}: element {i} port {g[i]!r} reference {w[i]!r}")
        n_diff += int((diff > 0).sum())
        n_all += diff.size
    assert n_diff <= STEP_SHARE * n_all, (n_diff, n_all)
    for k, p in before.items():        # the caller's tensors: untouched
        assert not p.requires_grad, k
        np.testing.assert_array_equal(
            f32(p), f32(dict(leaves(case["np_params"]))[k]))
