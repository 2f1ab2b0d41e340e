"""PyTorch/CUDA port of the LL-GNN JEDI-net system.

A second package beside the JAX reference (``repro``).  It keeps the
reference's module names so each counterpart is easy to find, imports
``torch`` and never ``jax``, and runs its entry points on the CUDA card
unless the caller asks for ``device="cpu"``.  Asking for ``cuda`` where
there is no card raises (:func:`resolve_device`); nothing falls back to
the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to exist.

    Raises ``RuntimeError`` for a CUDA device on a machine without one,
    so a GPU run can never quietly turn into a CPU run.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev
