"""Run one control of the LM decode cell: a served variant that the check
must fail.

    python3 bench_port/lm_control.py --workload moonlight-16b-a3b.decode_8k \\
        --seed <n> --seconds <s> --control fp8_weights|fp8_cache|no_shared|scale1

``fp8_weights`` serves every weight matrix rounded through float8 e4m3
(a scale per matrix) and ``fp8_cache`` keeps the latent cache in float8
e4m3, precisions below the configuration's bfloat16; ``no_shared``
serves without the shared experts; ``scale1`` with a routed scaling
factor of 1.  The reference is
the same as in a plain run.  The run is ``run.py``'s in every other
respect (untraced), and its last line is the result line.
"""

from __future__ import annotations

import argparse
import sys

import run as bench_run

CONTROLS = ("fp8_weights", "fp8_cache", "no_shared", "scale1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=CONTROLS, required=True)
    args = ap.parse_args(argv)
    args.trace = 0
    smi = bench_run._power_limit()
    try:
        return bench_run._main(args, smi)
    finally:
        if smi is not None and smi.poll() is None:
            smi.kill()
            smi.wait()


if __name__ == "__main__":
    sys.exit(main())
