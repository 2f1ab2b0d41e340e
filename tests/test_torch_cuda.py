"""The port's CUDA kernel on the card (skips without one).

Run on a machine with an H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` covers the same ground at the repo's full widths.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import interaction_net as inet
from repro_torch.core.int8_path import quantize_params_int8
from repro_torch.data.jets import make_jets
from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import ops


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
