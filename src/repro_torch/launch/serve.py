"""Batched LM serving driver of the port: prefill + decode loop with
continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --requests 8 --max-new 16

Serves on the CUDA card (``--device cuda``, the default; raises without
one), the decode step's attention on kernel B5, or with the plain
PyTorch versions on the CPU (``--device cpu``); ``--tiny`` swaps the
arch config for a 2-layer miniature (same code path).  All the behaviour
lives in :class:`repro_torch.serving.lm.LMEngine`; this module is the
thin shell (argparse + one call).
"""

from __future__ import annotations

import argparse

from repro_torch.serving.lm import (  # noqa: F401  (Request/tiny_config re-exported)
    LMRequest as Request,
    build_lm_cli,
    run_lm_cli,
    tiny_config,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    build_lm_cli(ap)
    return run_lm_cli(ap.parse_args(argv))


if __name__ == "__main__":
    main()
