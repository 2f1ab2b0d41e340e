"""JEDI-net weights drawn by the benchmark from ``--seed``, on the device.

The port's layout, ``{"fr"|"fo"|"phi": {"layers": [{"w": (in, out),
"b": (out,)}, ...]}}``, in fp32 (the configs' stated precision).  All of
it is one ``torch.randn`` on the generator's device, cut into layers:
weights at LeCun scale (std 1/sqrt(fan_in), which keeps an untrained
net's activations O(1) through the N_o-way sums) and biases at std
``BIAS_STD`` (the program's own init leaves them zero, so a bias the
kernel dropped would go unseen).
"""

from __future__ import annotations

import math

import torch

from bench_port.work.jedinet import mlp_dims

BIAS_STD = 0.1


def make_params(model: dict, gen: torch.Generator) -> dict:
    dims = dict(zip(("fr", "fo", "phi"), mlp_dims(model)))
    shapes = [(name, a, b) for name, d in dims.items()
              for a, b in zip(d[:-1], d[1:])]
    total = sum(a * b + b for _, a, b in shapes)
    flat = torch.randn(total, generator=gen, device=gen.device)
    params = {name: {"layers": []} for name in dims}
    pos = 0
    for name, a, b in shapes:
        w = flat[pos:pos + a * b].view(a, b) * (1.0 / math.sqrt(a))
        pos += a * b
        bias = flat[pos:pos + b] * BIAS_STD
        pos += b
        params[name]["layers"].append({"w": w, "b": bias})
    return params


def clone(params: dict) -> dict:
    """A copy sharing no storage: the reference's own weights."""
    return {name: {"layers": [{k: v.clone() for k, v in layer.items()}
                              for layer in mlp["layers"]]}
            for name, mlp in params.items()}
