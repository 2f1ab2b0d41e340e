"""Plain JEDI-net forward in PyTorch, fp32 with TF32 off: the yardstick.

Written from the interaction network's equations (JEDI-net,
arXiv:1908.05318, Sec. 3; LL-GNN, arXiv:2209.14065, Sec. 2), not from
the program: for every event of ``x`` (B, N_o, P)

* every ordered pair (r, s), r != s, of the N_o(N_o-1) pairs gets the
  edge input [x_r || x_s] (receiver first);
* f_R maps it to an edge message e_rs (d_e);
* the receiver sum Ebar_r = sum over s of e_rs;
* f_O maps [x_r || Ebar_r] to o_r (d_o);
* the node sum O = sum over r of o_r;
* phi_O maps O to the logits (n_targets).

Each MLP is dense layers with ``activation`` between them and none after
the last.  Weights are ``{"fr"|"fo"|"phi": {"layers": [{"w": (in, out),
"b": (out,)}, ...]}}``: the raw weights the benchmark drew, never the
program's split or packed forms.  Imports nothing but torch and the
benchmark's own ``judge`` (for the control's TF32 rounding).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench_port.judge import round_tf32

_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
                "gelu": torch.nn.functional.gelu}


@contextlib.contextmanager
def fp32_products():
    """fp32 matrix products with TF32 off (restored on exit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _dense(layer, h, products: str):
    w = layer["w"].float()
    if products == "tf32":
        h, w = round_tf32(h), round_tf32(w)
    return h @ w + layer["b"].float()


def mlp(p, h, activation: str, products: str = "fp32"):
    act = _ACTIVATIONS[activation]
    layers = p["layers"]
    for i, layer in enumerate(layers):
        h = _dense(layer, h, products)
        if i < len(layers) - 1:
            h = act(h)
    return h


def pairs(n_objects: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(receiver, sender) of every ordered pair r != s, receiver-major and
    senders ascending, so the receiver sum is a reshape and a sum."""
    r = torch.arange(n_objects, device=device)
    recv = r.repeat_interleave(n_objects - 1)
    grid = r.repeat(n_objects, 1)                       # (N, N): s per row
    keep = ~torch.eye(n_objects, dtype=torch.bool, device=device)
    send = grid[keep]                                   # row-major: r, then s
    return recv, send


def forward(params, model: dict, x: torch.Tensor,
            products: str = "fp32") -> torch.Tensor:
    """Logits (B, n_targets) in fp32 of ``x`` (B, N_o, P); ``products``
    is ``"fp32"`` or ``"tf32"`` (the control)."""
    act = model["activation"]
    n_o = model["n_objects"]
    x = x.float()
    b = x.shape[0]
    recv, send = pairs(n_o, x.device)
    with fp32_products():
        edge_in = torch.cat([x[:, recv], x[:, send]], dim=-1)   # (B, E, 2P)
        e = mlp(params["fr"], edge_in, act, products)           # (B, E, d_e)
        ebar = e.reshape(b, n_o, n_o - 1, -1).sum(dim=2)        # (B, N, d_e)
        o = mlp(params["fo"], torch.cat([x, ebar], dim=-1), act, products)
        return mlp(params["phi"], o.sum(dim=1), act, products)


def logits(params, model: dict, x: torch.Tensor, *, products: str = "fp32",
           block: int = 1024) -> np.ndarray:
    """:func:`forward` over ``x`` in blocks of ``block`` events, as a host
    array: the edge tensors of a whole pool would not fit the card."""
    outs = []
    with torch.no_grad():
        for i in range(0, x.shape[0], block):
            outs.append(forward(params, model, x[i:i + block],
                                products).cpu().numpy())
    return np.concatenate(outs, axis=0) if outs else np.zeros(
        (0, model["n_targets"]), np.float32)
