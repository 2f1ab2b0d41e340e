"""The port's CUDA kernels on the card (skips without one).

Run on a machine with an H100:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Each kernel (B1 whole JEDI-net, B2 JEDI-linear, B3 edge block) is held
against its plain version at 5e-4 of the result scale, and two launches
must be bitwise equal.  ``chip_smoke.py`` covers the same ground at the
repo's full widths.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import interaction_net as inet
from repro_torch.core.int8_path import quantize_params_int8
from repro_torch.data.jets import make_jets
from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import kernel as EK
from repro_torch.kernels.fused_jedinet import ops
from repro_torch.kernels.jedi_linear import linear_kernel as LK
from repro_torch.kernels.jedi_linear import ops as jl_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13, 257])
@pytest.mark.parametrize("quant", [False, True])
def test_kernel_matches_plain_version(cuda, batch, quant):
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    if quant:
        params = quantize_params_int8(params)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, 30)[0])
    x = x.to(cuda)
    bound = ops.bind_full(params, cfg)
    before = FK.fused_forward_full_kernel_call.launches
    out = ops.fused_forward_full(bound, cfg, x)
    assert FK.fused_forward_full_kernel_call.launches == before + 1
    ref = FK.fused_forward_full_plain(x, bound.fr, bound.fo, bound.phi,
                                      activation="relu", scales=bound.scales)
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= 5e-4 * scale
    assert torch.equal(out, ops.fused_forward_full(bound, cfg, x))


def _check(out, ref, again):
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= 5e-4 * scale
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13, 257])
@pytest.mark.parametrize("quant", [False, True])
def test_jedi_linear_kernel_matches_plain_version(cuda, batch, quant):
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    if quant:
        params = quantize_params_int8(params)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, 30)[0])
    x = x.to(cuda)
    bound = jl_ops.bind_linear(params, cfg)
    before = LK.jedi_linear_kernel_call.launches
    out = jl_ops.jedi_linear_forward_full(bound, cfg, x)
    assert LK.jedi_linear_kernel_call.launches == before + 1
    ref = LK.jedi_linear_forward_full_plain(
        x, bound.fr, bound.fo, bound.phi, activation="relu",
        scales=bound.scales)
    _check(out, ref, jl_ops.jedi_linear_forward_full(bound, cfg, x))


@pytest.mark.cuda
@pytest.mark.parametrize("n_o,batch", [(30, 13), (30, 257), (50, 5)])
def test_edge_block_kernel_matches_plain_version(cuda, n_o, batch):
    cfg = inet.JediNetConfig(n_objects=n_o)
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, n_o)[0])
    x = x.to(cuda)
    bound = ops.bind_edge(params["fr"], cfg)
    before = EK.fused_edge_block_kernel_call.launches
    out = ops.fused_edge_block(bound, cfg, x)
    assert EK.fused_edge_block_kernel_call.launches == before + 1
    assert out.shape == (batch, n_o, cfg.d_e)
    ref = EK.fused_edge_block_plain(x, bound.fr, activation="relu")
    _check(out, ref, ops.fused_edge_block(bound, cfg, x))
