"""Streaming L1-trigger serving CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.trigger_serve \
        --n-objects 30 --batch 256 --batches 40 --forward fused_full

Serves JEDI-net through the fault-tolerant ``ResilientEngine`` on the
CUDA card (``--device cuda``, the default) or with the plain PyTorch
versions on the CPU (``--device cpu``).  All the behaviour lives in
:mod:`repro_torch.serving.trigger`; this module is the thin shell.
"""

from __future__ import annotations

import argparse

from repro_torch.serving.trigger import build_trigger_cli, run_trigger_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    build_trigger_cli(ap)
    return run_trigger_cli(ap.parse_args(argv))


if __name__ == "__main__":
    main()
