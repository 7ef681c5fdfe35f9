"""The port's copy of the AP cost model prices exactly as the reference:
simulate_network reports, price_bit_matrix costs and the CNN budget
controller's prediction table are float-equal (==, not approx)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.apsim import metrics as japm  # noqa: E402
from repro.apsim.energy import RERAM as JRERAM, SRAM as JSRAM  # noqa: E402
from repro.apsim.mapper import (IR_CONFIG as JIR, LR_CONFIG as JLR,  # noqa: E402
                                simulate_network as jsim)
from repro.apsim.workloads import NETWORKS as JNETS  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.apsim.energy import RERAM, SRAM  # noqa: E402
from repro_torch.apsim.mapper import (IR_CONFIG, LR_CONFIG,  # noqa: E402
                                      simulate_network)
from repro_torch.apsim.workloads import (HAWQV3_RESNET18, NETWORKS,  # noqa: E402
                                         per_layer_bits)
from repro_torch.core import policy as tpol  # noqa: E402


def _asdict(report) -> dict:
    return dataclasses.asdict(report)


@pytest.mark.parametrize("network", sorted(NETWORKS))
@pytest.mark.parametrize("hw", ["lr-sram", "ir-reram"])
def test_simulate_network_float_equal(network, hw):
    cfg, tech, jcfg, jtech = ((LR_CONFIG, SRAM, JLR, JSRAM) if hw == "lr-sram"
                              else (IR_CONFIG, RERAM, JIR, JRERAM))
    for bits in (4, 8):
        got = simulate_network(NETWORKS[network](), cfg, tech, bits=bits,
                               network=network)
        want = jsim(JNETS[network](), jcfg, jtech, bits=bits,
                    network=network)
        assert _asdict(got) == _asdict(want)
        assert got.edp == want.edp


def test_simulate_network_hawq_vectors_float_equal():
    layers = NETWORKS["resnet18"]()
    for name, vec in HAWQV3_RESNET18.items():
        bits = per_layer_bits(layers, vec)
        got = simulate_network(layers, LR_CONFIG, SRAM, bits=bits,
                               network="resnet18")
        want = jsim(JNETS["resnet18"](), JLR, JSRAM, bits=bits,
                    network="resnet18")
        assert got.edp == want.edp, name
        assert got.energy_j == want.energy_j, name


def test_price_bit_matrix_float_equal(rng):
    layers = NETWORKS["resnet18"]()
    gemms_t = tapm.network_gemms(layers)
    gemms_j = japm.network_gemms(JNETS["resnet18"]())
    n = len(gemms_t)
    rows = [per_layer_bits(layers, v) for v in HAWQV3_RESNET18.values()]
    rand = rng.integers(1, 9, size=(4, n)).tolist()
    wmat = np.asarray(rows + rand, np.int64)
    amat = np.asarray(rows + rng.integers(1, 9, size=(4, n)).tolist(),
                      np.int64)
    got = tapm.price_bit_matrix(gemms_t, wmat, amat)
    want = japm.price_bit_matrix(gemms_j, wmat, amat)
    assert len(got) == len(want) == wmat.shape[0]
    for g, w in zip(got, want):
        assert g.per_layer_cycles == w.per_layer_cycles
        assert g.per_layer_energy_j == w.per_layer_energy_j
        assert g.edp == w.edp


def test_cnn_budget_controller_matches_reference():
    tc = tpol.cnn_budget_controller("resnet18")
    jc = jpol.cnn_budget_controller("resnet18")
    assert tc.order() == jc.order()
    assert tc.predicted_latency_s == jc.predicted_latency_s
    assert tc.budget_axis == jc.budget_axis == "edp"
    tw, ta = tc.stacked_tables()
    jw, ja = jc.stacked_tables()
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.latency_array().numpy(),
                                  np.asarray(jc.latency_array()))
    # budgets at, just below and just above every boundary select alike
    # (the float32 prediction table decides ties)
    preds = [jc.predicted_latency_s[k] for k in jc.order()]
    buds = np.asarray([b * f for b in preds for f in (0.999999, 1.0, 1.000001)]
                      + [0.0, 1e30], np.float64)
    tsel = tc.select(torch.as_tensor(buds, dtype=torch.float32)).numpy()
    jsel = np.asarray(jc.select(jnp.asarray(buds, jnp.float32)))
    np.testing.assert_array_equal(tsel, jsel)
    twm, tam = tc.resolve(torch.as_tensor(buds, dtype=torch.float32))
    jwm, jam = jc.resolve(jnp.asarray(buds, jnp.float32))
    np.testing.assert_array_equal(twm.numpy(), np.asarray(jwm))
    np.testing.assert_array_equal(tam.numpy(), np.asarray(jam))


@pytest.mark.parametrize("metric", ["energy", "latency"])
def test_cnn_budget_controller_axes_match(metric):
    tc = tpol.cnn_budget_controller("resnet18", metric=metric)
    jc = jpol.cnn_budget_controller("resnet18", metric=metric)
    assert tc.predicted_latency_s == jc.predicted_latency_s
    with pytest.raises(ValueError, match="metric"):
        tpol.cnn_budget_controller("resnet18", metric="flops")
    with pytest.raises(ValueError, match="explicit"):
        tpol.cnn_budget_controller("alexnet")
