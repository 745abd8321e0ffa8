"""Command line of the port.

    python -m metagenomic_deepfri_tpu_torch.cli verify-weights -w DIR --device cuda

``verify-weights`` takes the options of the JAX package's verb of that name
plus ``--device``, which is required: the port never picks a device by
itself. It prints one line per model and exits non-zero when any model
exceeds tolerance. The command line uses ``argparse`` only.
"""

from __future__ import annotations

import argparse
import logging
import sys

from metagenomic_deepfri_tpu_torch.parity import (DEFAULT_TOLERANCE,
                                                  verify_weights)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m metagenomic_deepfri_tpu_torch.cli")
    verbs = parser.add_subparsers(dest="verb", required=True)
    vw = verbs.add_parser(
        "verify-weights",
        help="Check port-vs-ONNX numerical parity for every model in a "
             "weights folder.")
    vw.add_argument("-w", "--weights", required=True,
                    help="Path to the folder containing model weights.")
    vw.add_argument("--device", required=True,
                    help="Where the port's forward runs: cuda, cuda:1, cpu.")
    vw.add_argument("--n-proteins", type=int, default=10,
                    help="Random proteins per model (default: 10).")
    vw.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="Max allowed abs score difference port vs ONNX "
                         "(default: %(default)s).")
    vw.add_argument("--logit-tolerance", type=float, default=None,
                    help="Max allowed scaled pre-softmax logit difference "
                         "(defaults to --tolerance).")
    vw.add_argument("--trace", action="store_true",
                    help="On failure, log a per-stage divergence report "
                         "(embed/gc*/pooled/fc*/logits).")
    vw.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    results = verify_weights(args.weights, device=args.device,
                             n_proteins=args.n_proteins,
                             tolerance=args.tolerance,
                             logit_tolerance=args.logit_tolerance,
                             seed=args.seed, trace=args.trace)
    for r in results:
        print(f"{r.net}/{r.mode}: scores max|diff|={r.max_abs_diff:.2e} "
              f"logits max|diff|={r.max_logit_diff:.2e} "
              f"({'OK' if r.ok else 'FAIL'})")
    failed = [r for r in results if not r.ok]
    if failed:
        print(f"Error: {len(failed)}/{len(results)} models exceed tolerance "
              f"{args.tolerance}", file=sys.stderr)
        return 1
    print(f"All {len(results)} models within {args.tolerance}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
