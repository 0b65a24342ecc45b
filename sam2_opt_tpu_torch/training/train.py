"""Training launcher CLI (re-design of sam2/training/train.py); counterpart
of `sam2_opt_tpu/training/train.py`.

    python -m sam2_opt_tpu_torch.training.train \\
        --img_folder MOSE/JPEGImages --gt_folder MOSE/Annotations \\
        --variant hiera_b+ --checkpoint sam2.1_hiera_base_plus.pt \\
        --num-epochs 40 --num-frames 8

    # data parallel over N cards, one process each (the reference's DDP)
    torchrun --nproc_per_node N -m sam2_opt_tpu_torch.training.train --dp N ...

Runs on the card unless `--device cpu`; without `--checkpoint` the weights
are random, drawn from `--seed`. Under torchrun every process builds the
same model, loads only its rows of each global batch (`--batch-size` is the
global size) and rank 0 logs and writes the checkpoints; `--backend gloo`
puts several ranks on one card.
"""

from __future__ import annotations

import argparse
import ast
import os


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
                        help="gradient-collective precision (reference DDP comms hook, "
                             "trainer.py:300-311): bfloat16 reduces the data-parallel "
                             "gradients in bf16, then upcasts them for the fp32 optimizer; "
                             "needs --compute-dtype bfloat16, --dp and --tp 1")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel mesh size (0 = no mesh, one process; -1 = every "
                             "rank after --tp)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel mesh size (shards the big linears over the "
                             "'model' axis)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process-group backend (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.dp:
        dp = args.dp if args.dp > 0 else world // args.tp
        if dp * args.tp != world:
            parser.error(f"--dp {args.dp} x --tp {args.tp} needs {dp * args.tp} processes, "
                         f"the world has {world} (launch with torchrun --nproc_per_node)")
        if args.batch_size % dp:
            parser.error(f"--batch-size {args.batch_size} must be divisible by dp={dp}")
    elif world > 1 or args.tp != 1:
        parser.error("multi-process runs and --tp need a mesh: pass --dp (e.g. --dp -1) so "
                     "the batch can be sharded across processes")
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
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.training.trainer import TrainConfig, Trainer

    mesh = None
    if args.dp:
        mesh = mesh_lib.make_mesh(dp, args.tp, backend=args.backend, device=args.device)

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
        grad_accum_steps=args.grad_accum_steps, compute_dtype=args.compute_dtype,
        comms_dtype=args.comms_dtype)
    trainer = Trainer(cfg, model, tcfg, mesh=mesh)

    raw = PNGRawDataset(args.img_folder, args.gt_folder)
    ds = VOSDataset(raw, RandomUniformSampler(num_frames=args.num_frames,
                                              max_num_objects=args.max_objects),
                    image_size=cfg.image_size, max_num_objects=args.max_objects, seed=args.seed)

    # each process loads only its rows of every global batch (the
    # reference's per-rank DistributedSampler)
    batch_rows = (mesh_lib.process_local_batch_rows(mesh, args.batch_size)
                  if mesh is not None else None)

    def train_loader(epoch):
        ds.set_epoch(epoch)
        return data_loader(ds, args.batch_size, seed=args.seed + epoch, batch_rows=batch_rows)

    val_loader = None
    if args.val_img_folder:
        vds = VOSDataset(PNGRawDataset(args.val_img_folder, args.val_gt_folder), EvalSampler(),
                         image_size=cfg.image_size, max_num_objects=args.max_objects,
                         hflip_prob=0.0)

        def val_loader(epoch):
            if mesh is None:
                return data_loader(vds, 1, shuffle=False, drop_last=False)
            # a video per data rank; a ragged last batch is padded and its
            # padding counts for nothing (`row_valid`)
            return data_loader(vds, dp, shuffle=False, drop_last=False,
                               batch_rows=mesh_lib.process_local_batch_rows(mesh, dp))

    steps_per_epoch = max(len(ds) // args.batch_size, 1)
    if trainer.rank0:
        print(f"training {args.variant} on {len(ds)} videos, {steps_per_epoch} steps/epoch, "
              f"device {trainer.device}, {world} process(es)")
    trainer.run(train_loader, val_loader, steps_per_epoch=steps_per_epoch)
    return trainer  # for callers in the same process and tests; the CLI ignores it


if __name__ == "__main__":
    main()
