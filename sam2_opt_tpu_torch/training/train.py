"""Training launcher CLI (re-design of sam2/training/train.py); counterpart
of `sam2_opt_tpu/training/train.py` on one device.

    python -m sam2_opt_tpu_torch.training.train \\
        --img_folder MOSE/JPEGImages --gt_folder MOSE/Annotations \\
        --variant hiera_b+ --checkpoint sam2.1_hiera_base_plus.pt \\
        --num-epochs 40 --num-frames 8

Runs on the card unless `--device cpu`; without `--checkpoint` the weights
are random, drawn from `--seed`.
"""

from __future__ import annotations

import argparse
import ast


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="hiera_b+")
    parser.add_argument("--checkpoint", default=None, help="reference .pt checkpoint")
    parser.add_argument("--img_folder", required=True)
    parser.add_argument("--gt_folder", required=True)
    parser.add_argument("--val_img_folder", default=None)
    parser.add_argument("--val_gt_folder", default=None)
    parser.add_argument("--num-epochs", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--max-objects", type=int, default=3)
    parser.add_argument("--lr", type=float, default=5e-6)
    parser.add_argument("--layer-decay", type=float, default=0.8)
    parser.add_argument("--image-size", type=int, default=None)
    parser.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                        help="model-config override, dotted keys allowed (e.g. "
                             "trunk.stages='(1,1,1,1)'); values are python literals")
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--checkpoint-dir", default="checkpoints_train")
    parser.add_argument("--freeze-image-encoder", action="store_true")
    parser.add_argument("--remat", default="encoder",
                        choices=("none", "encoder", "blocks", "blocks_frames"),
                        help="what the backward recomputes: the batched encoder, each trunk "
                             "block, or each block and each rollout frame")
    parser.add_argument("--grad-accum-steps", type=int, default=1,
                        help="sequential micro-batches per optimizer step; the batch size "
                             "must be divisible by this")
    parser.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                        help="rollout compute dtype; bfloat16 = mixed precision (fp32 master "
                             "weights, loss and optimizer)")
    parser.add_argument("--comms-dtype", default=None, choices=("bfloat16",),
                        help="gradient-collective precision (needs a mesh: not ported yet)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel mesh size (not ported yet: 0 only)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel mesh size (not ported yet: 1 only)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    for flag, value, default in (("--dp", args.dp, 0), ("--tp", args.tp, 1),
                                 ("--comms-dtype", args.comms_dtype, None)):
        if value != default:
            raise NotImplementedError(f"{flag} is not ported yet: the port trains on one "
                                      "device (ROADMAP.md, Queue A item 13)")
    if args.batch_size % max(args.grad_accum_steps, 1) != 0:
        parser.error(f"--batch-size {args.batch_size} must be divisible by "
                     f"--grad-accum-steps {args.grad_accum_steps}")

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.models.model import build_sam2
    from sam2_opt_tpu_torch.training.data import (
        EvalSampler,
        PNGRawDataset,
        RandomUniformSampler,
        VOSDataset,
        data_loader,
    )
    from sam2_opt_tpu_torch.training.trainer import TrainConfig, Trainer

    overrides = {}
    if args.image_size:
        overrides["image_size"] = args.image_size
    for item in args.override:
        key, sep, raw = item.partition("=")
        if not sep:
            parser.error(f"--override needs KEY=VALUE, got {item!r}")
        try:
            overrides[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            overrides[key] = raw
    cfg = model_config(args.variant, **overrides)
    model = build_sam2(args.variant, checkpoint_path=args.checkpoint, seed=args.seed, cfg=cfg,
                       device=args.device).module

    tcfg = TrainConfig(
        num_epochs=args.num_epochs, batch_size=args.batch_size, num_frames=args.num_frames,
        max_num_objects=args.max_objects, base_lr=args.lr, layer_decay=args.layer_decay,
        log_dir=args.log_dir, checkpoint_dir=args.checkpoint_dir,
        freeze_image_encoder=args.freeze_image_encoder, seed=args.seed, remat=args.remat,
        grad_accum_steps=args.grad_accum_steps, compute_dtype=args.compute_dtype)
    trainer = Trainer(cfg, model, tcfg)

    raw = PNGRawDataset(args.img_folder, args.gt_folder)
    ds = VOSDataset(raw, RandomUniformSampler(num_frames=args.num_frames,
                                              max_num_objects=args.max_objects),
                    image_size=cfg.image_size, max_num_objects=args.max_objects, seed=args.seed)

    def train_loader(epoch):
        ds.set_epoch(epoch)
        return data_loader(ds, args.batch_size, seed=args.seed + epoch)

    val_loader = None
    if args.val_img_folder:
        vds = VOSDataset(PNGRawDataset(args.val_img_folder, args.val_gt_folder), EvalSampler(),
                         image_size=cfg.image_size, max_num_objects=args.max_objects,
                         hflip_prob=0.0)

        def val_loader(epoch):
            return data_loader(vds, 1, shuffle=False, drop_last=False)

    steps_per_epoch = max(len(ds) // args.batch_size, 1)
    print(f"training {args.variant} on {len(ds)} videos, {steps_per_epoch} steps/epoch, "
          f"device {trainer.device}")
    trainer.run(train_loader, val_loader, steps_per_epoch=steps_per_epoch)
    return trainer  # for callers in the same process and tests; the CLI ignores it


if __name__ == "__main__":
    main()
