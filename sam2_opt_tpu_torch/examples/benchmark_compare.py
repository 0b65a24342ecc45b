"""J&F metric CLI (counterpart of `examples/benchmark_compare.py`; reference
benchmark_compare.py:1-85) over the port's `eval/sav_benchmark.py`.

Directory layouts (same as the reference docs, benchmark_compare.py:11-37):

SA-V:
  gt_root/<video>/<obj_id>/<frame>.png   (binary per-object pngs)
DAVIS:
  gt_root/<video>/<frame>.png            (multi-object palette pngs)

    python -m sam2_opt_tpu_torch.examples.benchmark_compare --gt_root GT
        --pred_root PRED [--num_processes N] [--strict]
        [--do_not_skip_first_and_last_frame]
"""

from __future__ import annotations

import argparse

from sam2_opt_tpu_torch.eval.sav_benchmark import benchmark


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_root", required=True, help="ground-truth mask root")
    parser.add_argument("--pred_root", required=True, help="predicted mask root")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--strict", action="store_true")
    parser.add_argument(
        "--do_not_skip_first_and_last_frame", action="store_true",
        help="SA-V val/test and DAVIS semi-supervised skip first/last annotated frames by default")
    args = parser.parse_args(argv)
    jf, j, f, _ = benchmark([args.gt_root], [args.pred_root], strict=args.strict,
                            num_processes=args.num_processes,
                            skip_first_and_last=not args.do_not_skip_first_and_last_frame)
    print(f"J&F: {jf[0]:.1f}  J: {j[0]:.1f}  F: {f[0]:.1f}")
    return jf[0], j[0], f[0]


if __name__ == "__main__":
    main()
