"""The plain reference against the port's ``forward_sr_split`` on the CPU,
at the published widths, and its control in TF32 against both."""

import numpy as np
import pytest
import torch

from bench_port import harness, judge
from bench_port.data import jedinet_weights
from bench_port.data.jets import make_jets
from bench_port.reference import jedinet as ref


def _case(name, seed=3, n=6):
    config = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    gen = torch.Generator().manual_seed(seed)
    params = jedinet_weights.make_params(config["model"], gen)
    x, _ = make_jets(gen, n, config["model"]["n_objects"])
    return config, params, x


def _port(config, params, x):
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import interaction_net as inet
    cfg = get_arch(config["arch_id"]).model
    return inet.forward_sr_split(params, cfg, x).numpy()


@pytest.mark.parametrize("name", ["jedinet-30p", "jedinet-50p"])
def test_reference_agrees_with_the_ports_plain_forward(name):
    config, params, x = _case(name)
    mine = ref.logits(params, config["model"], x)
    port = _port(config, params, x)
    assert mine.shape == (x.shape[0], config["model"]["n_targets"])
    assert judge.logit_gap(port, mine) < 1e-5


@pytest.mark.parametrize("name", ["jedinet-30p", "jedinet-50p"])
def test_tf32_control_is_far_from_both(name):
    config, params, x = _case(name, seed=4)
    fp32 = ref.logits(params, config["model"], x)
    tf32 = ref.logits(params, config["model"], x, products="tf32")
    assert judge.logit_gap(tf32, fp32) > float(config["logit_gap_limit"])
    assert judge.logit_gap(tf32, _port(config, params, x)) \
        > float(config["logit_gap_limit"])


def test_reference_sees_a_dropped_bias():
    config, params, x = _case("jedinet-30p", seed=5)
    full = ref.logits(params, config["model"], x)
    params["fo"]["layers"][1]["b"].zero_()
    assert judge.logit_gap(ref.logits(params, config["model"], x), full) \
        > 1e-3


def test_pairs_are_every_ordered_pair_once():
    recv, send = ref.pairs(5, "cpu")
    got = sorted(zip(recv.tolist(), send.tolist()))
    assert got == [(r, s) for r in range(5) for s in range(5) if r != s]
    assert recv.tolist() == sorted(recv.tolist())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-3])
    r = judge.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0 ** -10
    assert r[2] == 1.0 + 2.0 ** -10          # a tie rounds away from zero
    assert r[3] == 1.0
    assert r[4] == -(1.0 + 2.0 ** -10)
    assert abs(float(r[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


def test_gap_meter_marks_missing_and_non_finite_answers():
    m = judge.GapMeter()
    ref_block = np.ones((3, 5), np.float32)
    m.add(ref_block + 1e-3, ref_block)
    assert m.gap == pytest.approx(1e-3, rel=1e-3)
    m.add(None, ref_block)
    assert m.gap == float("inf")
    m2 = judge.GapMeter()
    m2.add(np.full((3, 5), np.nan), ref_block)
    assert m2.gap == float("inf")
