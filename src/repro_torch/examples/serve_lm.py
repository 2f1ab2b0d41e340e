"""Continuous-batching LM serving demo (port of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Runs the h2o-danube arch (reduced dims, same code) through the serving
driver: request queue -> prefill -> batched decode with slot recycling,
on the CUDA card unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve.main([
        "--arch", "h2o-danube-1.8b",
        "--tiny",
        "--requests", "8",
        "--slots", "4",
        "--prompt-len", "24",
        "--max-new", "12",
        "--max-seq", "64",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
