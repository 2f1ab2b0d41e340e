"""The all-to-all MoE dispatch across ranks, on CPU ``gloo`` groups.

Counterpart of ``tests/test_multidevice.py::
test_a2a_moe_dispatch_matches_global``: ``parallel/moe_dispatch.a2a_moe``
on 2 and 4 ranks against the global ``moe_apply`` with ample capacity, at
4, 2 and 1 experts a rank, on the reference's weights (``bridge``).

Where a rank owns one expert the port's dispatch also equals the
reference's own ``a2a_moe_shard`` (its axis bound by ``vmap``); where a
rank owns two, the reference's receive reshape
(``src/repro/parallel/moe_dispatch.py:86``) misroutes tokens, and the
port, which transposes first, keeps agreeing with ``moe_apply``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro.parallel import moe_dispatch as jdispatch
from repro_torch import bridge
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as moe_lib
from repro_torch.parallel.moe_dispatch import a2a_moe
from torch_ranks import run_ranks

#: ``a2a_moe`` against the global ``moe_apply`` with ample capacity, of
#: the output's scale (at least 1).
TOL_A2A = 1e-5
TOKENS, D_MODEL, D_FF = 64, 16, 32


def _case(n_experts):
    """(port config, reference config, reference params, x)."""
    kw = dict(n_experts=n_experts, top_k=2, capacity_factor=8.0)
    jcfg = jbase.MoEConfig(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, D_MODEL, D_FF)
    x = np.random.RandomState(1).normal(
        size=(TOKENS, D_MODEL)).astype(np.float32)
    return MoEConfig(**kw), jcfg, jp, x


def _rank_a2a(rank, world, inp, out):
    got = {}
    for n_experts, (moe, params, x) in torch.load(
            inp, weights_only=False).items():
        ref, _ = moe_lib.moe_apply(params, moe, x,
                                   compute_dtype=torch.float32)
        got[n_experts] = {"y": a2a_moe(x, params, moe), "moe_apply": ref}
    if rank == 0:
        torch.save(got, out)


def _run(tmp_path, world, experts):
    inputs = {}
    for n in experts:
        moe, _, jp, x = _case(n)
        inputs[n] = (moe, bridge.params_from_jax(jp, device="cpu"),
                     torch.from_numpy(x))
    torch.save(inputs, tmp_path / "in.pt")
    run_ranks(_rank_a2a, world, tmp_path, tmp_path / "in.pt",
              tmp_path / "out.pt")
    return torch.load(tmp_path / "out.pt")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """8 experts (2 a rank) and 4 experts (1 a rank) over one 4-rank group."""
    return _run(tmp_path_factory.mktemp("a2a4"), 4, (8, 4))


def _reference_a2a(jcfg, jp, x, n_shards):
    """The reference's ``a2a_moe_shard`` with its axis bound by ``vmap``."""
    cap = jmoe.capacity(x.shape[0] // n_shards, jcfg)
    fn = functools.partial(
        jdispatch.a2a_moe_shard, n_experts=jcfg.n_experts, cap=cap,
        axis_name="d", n_shards=n_shards, top_k=jcfg.top_k)
    out = jax.vmap(fn, in_axes=(0, None), axis_name="d")(
        jnp.asarray(x.reshape(n_shards, -1, x.shape[1])), jp)
    return np.asarray(out).reshape(x.shape)


def _err(got, want) -> float:
    """Max |got - want| over the scale of ``want`` (at least 1)."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def test_a2a_moe_matches_the_global_moe_apply_on_2_ranks(tmp_path):
    """8 experts over 2 ranks: 4 experts a rank."""
    r = _run(tmp_path, 2, (8,))[8]
    assert _err(r["y"], r["moe_apply"]) <= TOL_A2A


@pytest.mark.parametrize("n_experts", [8, 4])
def test_a2a_moe_matches_the_global_moe_apply_on_4_ranks(four_ranks,
                                                         n_experts):
    r = four_ranks[n_experts]
    assert _err(r["y"], r["moe_apply"]) <= TOL_A2A


def test_a2a_moe_matches_the_reference_at_one_expert_a_rank(four_ranks):
    """4 experts over 4 ranks: the port's dispatch equals the reference's
    ``a2a_moe_shard``, where its wiring is right."""
    _, jcfg, jp, x = _case(4)
    assert _err(four_ranks[4]["y"], _reference_a2a(jcfg, jp, x, 4)) \
        <= TOL_A2A


def test_a2a_moe_departs_from_the_reference_at_two_experts_a_rank(
        four_ranks):
    """8 experts over 4 ranks: the port agrees with the reference's global
    ``moe_apply``; the reference's own dispatch does not."""
    _, jcfg, jp, x = _case(8)
    glob, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x),
                             compute_dtype=jnp.float32)
    assert _err(four_ranks[8]["y"], glob) <= TOL_A2A
    assert _err(_reference_a2a(jcfg, jp, x, 4), glob) > 0.1

