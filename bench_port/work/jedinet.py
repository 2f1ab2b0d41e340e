"""The work of one JEDI-net event, counted from the model's shapes.

Frozen here from ``chip_smoke.py``'s ``fused_full_work`` (``_edge_ops``,
``_readout_ops``) so that the yardstick cannot move with the program.
Operations are 2 per multiply-add of the dense layers plus the adds of
the split first layer and of the two sums, over the edges that exist
(the self-edge is skipped); bytes are x read once, the logits written
once and the fp32 weights read once per launch.  jedinet-30p: 1,859,640
operations and 1,940 bytes an event; jedinet-50p: 27,638,700 and 3,220.
"""

from __future__ import annotations


def _mlp_ops(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_dims(model: dict) -> tuple[list, list, list]:
    p = model["n_features"]
    return ([2 * p, *model["fr_hidden"], model["d_e"]],
            [p + model["d_e"], *model["fo_hidden"], model["d_o"]],
            [model["d_o"], *model["phi_hidden"], model["n_targets"]])


def edge_ops(model: dict) -> int:
    """u_r and u_s per node (the first layer split over [x_r || x_s]),
    then per edge the split sum (2 adds per first-layer output), f_R's
    other layers and the receiver sum."""
    fr = mlp_dims(model)[0]
    n_o, h1 = model["n_objects"], fr[1]
    per_edge = _mlp_ops(fr[1:]) + 2 * h1 + model["d_e"]
    return n_o * 2 * 2 * model["n_features"] * h1 + n_o * (n_o - 1) * per_edge


def readout_ops(model: dict) -> int:
    """f_O per node, the node sum and phi_O."""
    _, fo, phi = mlp_dims(model)
    return model["n_objects"] * (_mlp_ops(fo) + model["d_o"]) + _mlp_ops(phi)


def ops_per_event(model: dict) -> int:
    return edge_ops(model) + readout_ops(model)


def io_bytes_per_event(model: dict) -> int:
    """fp32 x in and fp32 logits out."""
    return 4 * (model["n_objects"] * model["n_features"] + model["n_targets"])


def weight_bytes(model: dict) -> int:
    return 4 * sum(a * b + b for dims in mlp_dims(model)
                   for a, b in zip(dims[:-1], dims[1:]))


def launch_work(model: dict, events: int) -> tuple[float, float]:
    """(operations, bytes) of one launch over ``events`` valid events."""
    return (float(events * ops_per_event(model)),
            float(events * io_bytes_per_event(model) + weight_bytes(model)))
