"""SA-V evaluator CLI (re-design of sam2/sav_dataset/sav_evaluator.py);
counterpart of `sam2_opt_tpu/eval/sav_evaluator.py`:
`python -m sam2_opt_tpu_torch.eval.sav_evaluator --gt_root ... --pred_root ...`.

Thin argparse wrapper over eval.sav_benchmark.benchmark, mirroring the
reference's flags.
"""

from __future__ import annotations

import argparse

from sam2_opt_tpu_torch.eval.sav_benchmark import benchmark


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--gt_root", required=True,
        help="Path to the GT folder: sav_val/Annotations_6fps or "
             "sav_test/Annotations_6fps",
    )
    parser.add_argument(
        "--pred_root", required=True,
        help="Path to a similar structure of predicted masks",
    )
    def _str2bool(v: str) -> bool:
        # argparse type=bool treats any non-empty string (incl. "False") as
        # True; parse the usual spellings instead
        if v.lower() in ("1", "true", "yes", "y"):
            return True
        if v.lower() in ("0", "false", "no", "n"):
            return False
        raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")

    parser.add_argument("--num_processes", default=16, type=int)
    parser.add_argument("--verbose", default=True, type=_str2bool)
    parser.add_argument(
        "--strict", help="whether to require all gt videos predicted",
        default=True, type=_str2bool,
    )
    parser.add_argument(
        "--do_not_skip_first_and_last_frame",
        help="SA-V val and test only annotate every 4th frame; by default the "
             "first and last annotated frames are skipped like DAVIS",
        action="store_true",
    )
    args = parser.parse_args()
    benchmark(
        [args.gt_root],
        [args.pred_root],
        args.strict,
        args.num_processes,
        verbose=args.verbose,
        skip_first_and_last=not args.do_not_skip_first_and_last_frame,
    )


if __name__ == "__main__":
    main()
