"""The port's unfused B3 oracle (``kernels/fused_jedinet/ref.py``).

``fused_edge_block_ref`` is held against the reference's
``repro.kernels.fused_jedinet.ref.fused_edge_block_ref`` on bridged
weights and the same numpy jets at 2e-4 (of a scale of at least 1), and
against B3's plain version ``kernel.fused_edge_block_plain`` (which sums
the senders in the kernel's order) on the CPU.  On the card
``chip_smoke.py`` phase 4 holds B3 itself against this oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interaction_net as jinet
from repro.data.jets import make_jets
from repro.kernels.fused_jedinet.ref import fused_edge_block_ref as jref
from repro_torch import bridge
from repro_torch.core import interaction_net as tinet
from repro_torch.kernels.fused_jedinet import kernel as EK
from repro_torch.kernels.fused_jedinet import ops
from repro_torch.kernels.fused_jedinet.ref import fused_edge_block_ref

TOL = 2e-4

CFGS = {
    "30p": dict(n_objects=30),
    "13p-narrow": dict(n_objects=13, fr_hidden=(16, 12), fo_hidden=(10,),
                       phi_hidden=(12,)),
    "13p-gelu": dict(n_objects=13, fr_hidden=(16,), fo_hidden=(10,),
                     phi_hidden=(12,), activation="gelu"),
}


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    return jax.jit(lambda key: jinet.init(key, jcfg, scale="lecun"))(
        jax.random.PRNGKey(0))


def _setup(name, batch):
    jcfg = jinet.JediNetConfig(**CFGS[name])
    tcfg = tinet.JediNetConfig(**CFGS[name])
    jp = jax.tree_util.tree_map(np.asarray, _jax_init(jcfg))
    x, _ = make_jets(np.random.RandomState(3), batch, jcfg.n_objects)
    return jcfg, tcfg, jp, bridge.params_from_jax(jp, device="cpu"), x


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("cfg,batch", [("30p", 5), ("13p-narrow", 7),
                                       ("13p-gelu", 3)])
def test_oracle_matches_the_jax_oracle(cfg, batch):
    jcfg, tcfg, jp, tp, x = _setup(cfg, batch)
    want = jref(jp["fr"], jcfg, jnp.asarray(x))
    got = fused_edge_block_ref(tp["fr"], tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("cfg,batch", [("30p", 5), ("13p-narrow", 7),
                                       ("13p-gelu", 3)])
def test_oracle_matches_the_kernels_plain_version(cfg, batch):
    _, tcfg, _, tp, x = _setup(cfg, batch)
    xt = torch.from_numpy(x)
    bound = ops.bind_edge(tp["fr"], tcfg)
    plain = EK.fused_edge_block_plain(xt, bound.fr,
                                      activation=tcfg.activation)
    _close(fused_edge_block_ref(tp["fr"], tcfg, xt).numpy(), plain.numpy())
