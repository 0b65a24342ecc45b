"""Ranks of the port's data- and tensor-parallel CPU tests.

`launch(world, jobs, out)` starts `world` processes of this file, joined by
gloo over localhost on a free port (torchrun's variables set by hand, one
torch thread each); every rank runs each named job in turn, on a mesh the
job makes, and saves its result as `out/<job>_<rank>.pt`. The tests run the
same job functions with `mesh=None` in their own process for the
one-process reference. Sizes: hiera_t at 128 px with a one-block-per-stage
trunk (one global block) and 2 memory-attention layers, whose linears still
reach the TP rule's 1024 features (stage 3-4 MLPs and qkv, the decoder's
MLPs, memory attention's linear1).
"""

import argparse
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

S, T = 128, 2
TINY = {"trunk.stages": (1, 1, 1, 1), "trunk.global_att_blocks": (2,),
        "memory_attention.num_layers": 2}
OVERRIDES = [arg for k, v in TINY.items() for arg in ("--override", f"{k}={v!r}")]


def tiny_cfg():
    from sam2_opt_tpu_torch.config import model_config

    return model_config("hiera_t", image_size=S, **TINY)


def tiny_model(cfg, seed=0):
    """Random weights, the object-score head's last bias raised by 10 so the
    objects score present and the mask losses carry gradient."""
    from sam2_opt_tpu_torch.models.model import build_sam2

    sam = build_sam2("hiera_t", cfg=cfg, seed=seed, device="cpu")
    with torch.no_grad():
        sam.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    return sam


def mesh_of(dp, tp):
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(dp, tp, backend="gloo", device="cpu")


def video_batch(B, seed=17):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((B, T, S, S, 3)).astype(np.float32))
    masks = torch.zeros(B, T, 2, S, S, dtype=torch.bool)
    masks[:, :, 0, 20:80, 50:110] = True
    masks[:, :, 1, 70:120, 10:60] = True
    return images, masks, torch.ones(B, 2, dtype=torch.bool)


class CaptureOptimizer:
    """Records the reduced gradients (and the global norm a TP step hands
    over) and leaves the parameters as they are."""

    def init(self, params):
        return {}

    def lr_at(self, where):
        return 0.0

    def update(self, grads, state, params, lr, grad_norm=None):
        self.grads, self.grad_norm = grads, grad_norm
        return {n: torch.zeros_like(g) for n, g in grads.items()}, state


def train_grads(mesh, *, B=2, clicks=True, dtype="float32", comms=None):
    """(loss, whole reduced gradients, global norm) of one step of
    `build_train_step` on the global batch `video_batch(B)`: point prompts
    and a correction click on frame 1 drawn from the per-row generators, or
    a mask prompt and no clicks."""
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.parallel import tp as tp_lib
    from sam2_opt_tpu_torch.training.trainer import TrainConfig, build_train_step, row_generators

    cfg = tiny_cfg()
    model = tiny_model(cfg).module
    sharded = tp_lib.shard_module(model, mesh) if mesh is not None else {}
    tcfg = TrainConfig(batch_size=B, num_frames=T, num_correction_clicks=int(clicks),
                       compute_dtype=dtype, comms_dtype=comms, remat="none")
    opt = CaptureOptimizer()
    kwargs = dict(correct_frames=(1,)) if clicks else dict(use_mask=True)
    step = build_train_step(cfg, tcfg, opt, mesh, sharded=sharded, **kwargs)
    images, masks, valid = video_batch(B)
    rows = mesh_lib.process_local_batch_rows(mesh, B)
    take = slice(rows[0], rows[-1] + 1)
    _, metrics = step(model, opt.init(None), images[take], masks[take], valid[take],
                      row_generators(0, 0, rows, "cpu"), 1e-4)
    grads = mesh_lib.fetch_global(opt.grads, mesh, sharded)
    norm = opt.grad_norm if opt.grad_norm is not None else torch.sqrt(
        sum((g ** 2).sum() for g in opt.grads.values()))
    return {"loss": float(metrics["loss"]), "grads": grads, "norm": float(norm)}


def comms_raises(mesh):
    """The JAX package's comms_dtype errors under a mesh: tp != 1 (`mesh`),
    and grad_accum_steps > 1 on a data-parallel mesh."""
    from sam2_opt_tpu_torch.training.trainer import TrainConfig, build_train_step

    bf16 = dict(compute_dtype="bfloat16", comms_dtype="bfloat16")
    out = {}
    for name, tcfg, on in (("tp", TrainConfig(**bf16), mesh),
                           ("accum", TrainConfig(grad_accum_steps=2, batch_size=2, **bf16),
                            mesh_of(2, 1))):
        try:
            build_train_step(tiny_cfg(), tcfg, CaptureOptimizer(), on)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def make_png_dataset(root, num_videos=2, num_frames=3, val_videos=3):
    """A DAVIS-layout folder of PNG frames and palette annotations, and one of
    `val_videos` under `root/val` (odd: the last global val batch of dp 2 is
    ragged)."""
    if val_videos:
        make_png_dataset(f"{root}/val", val_videos, num_frames, val_videos=0)
    from PIL import Image

    rng = np.random.default_rng(5)
    for v in range(num_videos):
        for sub in ("JPEGImages", "Annotations"):
            os.makedirs(f"{root}/{sub}/video{v}", exist_ok=True)
        for t in range(num_frames):
            img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
            ann = np.zeros((S, S), np.uint8)
            ann[20 + 5 * t:70 + 5 * t, 30 + 10 * v:90 + 10 * v] = 1
            Image.fromarray(img).save(f"{root}/JPEGImages/video{v}/{t:05d}.png")
            Image.fromarray(ann, mode="P").save(f"{root}/Annotations/video{v}/{t:05d}.png")


def cli_args(root, ckpt, extra=()):
    return ["--img_folder", f"{root}/JPEGImages", "--gt_folder", f"{root}/Annotations",
            "--variant", "hiera_t", "--image-size", str(S), *OVERRIDES, "--num-epochs", "1",
            "--batch-size", "2", "--num-frames", "2", "--max-objects", "1",
            "--val_img_folder", f"{root}/val/JPEGImages", "--val_gt_folder",
            f"{root}/val/Annotations", "--checkpoint-dir", ckpt, "--log-dir", f"{ckpt}_logs",
            "--device", "cpu", *extra]


def cli(root):
    """`train.py --dp 2` (one step of a global batch of 2 videos, then the
    val loop over 3 videos), then a fresh trainer on every rank restoring the
    checkpoint; counts each rank's checkpoint writes."""
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.training import checkpoints
    from sam2_opt_tpu_torch.training.train import main
    from sam2_opt_tpu_torch.training.trainer import TrainConfig, Trainer

    writes, loaded = [], []
    save, place = checkpoints.CheckpointManager.save, Trainer._place_batch
    checkpoints.CheckpointManager.save = lambda self, step, state: (writes.append(step),
                                                                    save(self, step, state))

    def placed(self, batch, N):
        # the videos this rank loaded: one pixel sum per row
        loaded.append(np.asarray(batch["images"], np.float64).sum((1, 2, 3, 4)).tolist())
        return place(self, batch, N)

    Trainer._place_batch = placed
    try:
        ckpt = f"{root}/ckpt_dp2"
        trainer = main(cli_args(root, ckpt, ("--dp", "2", "--backend", "gloo")))
        params = mesh_lib.fetch_global(trainer.model.state_dict(), trainer.mesh, trainer.sharded)
        cfg = tiny_cfg()
        fresh = Trainer(cfg, tiny_model(cfg, seed=1).module,
                        TrainConfig(checkpoint_dir=ckpt, log_dir=f"{ckpt}_logs2"),
                        mesh=trainer.mesh)
        resumed = fresh.load_checkpoint()
        restored = mesh_lib.fetch_global(fresh.model.state_dict(), fresh.mesh, fresh.sharded)
    finally:
        checkpoints.CheckpointManager.save, Trainer._place_batch = save, place
    return {"losses": trainer.step_losses, "val_loss": trainer.best_val_loss, "writes": writes,
            "loaded": loaded, "resumed": resumed, "steps": fresh.steps, "params": params,
            "restored": restored}


def cli_one_process(root):
    """`train.py` without a mesh on the same folders as `cli`: its step
    losses and val loss, and the val loss of its trained model again over a
    loader of 2 videos a batch (a ragged last batch of 1)."""
    from sam2_opt_tpu_torch.training.data import EvalSampler, PNGRawDataset, VOSDataset, data_loader
    from sam2_opt_tpu_torch.training.train import main

    trainer = main(cli_args(root, f"{root}/ckpt_one"))
    vds = VOSDataset(PNGRawDataset(f"{root}/val/JPEGImages", f"{root}/val/Annotations"),
                     EvalSampler(), image_size=S, max_num_objects=1, hflip_prob=0.0)
    again = trainer.val_epoch(data_loader(vds, 2, shuffle=False, drop_last=False))
    return {"losses": trainer.step_losses, "val_loss": trainer.best_val_loss,
            "val_loss_batch2": again}


def cli_global_batches(root):
    """The pixel sums per row of the global batches `train.py` builds in one
    process (epoch 0)."""
    from sam2_opt_tpu_torch.training.data import (
        PNGRawDataset,
        RandomUniformSampler,
        VOSDataset,
        data_loader,
    )

    ds = VOSDataset(PNGRawDataset(f"{root}/JPEGImages", f"{root}/Annotations"),
                    RandomUniformSampler(num_frames=2, max_num_objects=1), image_size=S,
                    max_num_objects=1, seed=0)
    ds.set_epoch(0)
    return [np.asarray(b["images"], np.float64).sum((1, 2, 3, 4)).tolist()
            for b in data_loader(ds, 2, seed=0)]


def images_and_prompts():
    rng = np.random.default_rng(3)
    images = [(rng.random((96, 160, 3)) * 255).astype(np.uint8) for _ in range(2)]
    points = [np.array([[40.0, 50.0]]), np.array([[120.0, 30.0], [60.0, 60.0]])]
    labels = [np.array([1]), np.array([1, 0])]
    return images, points, labels


def image_predictor(mesh):
    """`predict_batch` of 2 images (and `predict` on image 1) from
    SAM2ImagePredictor(mesh=)."""
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

    predictor = SAM2ImagePredictor(tiny_model(tiny_cfg()), mesh=mesh)
    images, points, labels = images_and_prompts()
    predictor.set_image_batch(images)
    masks, ious, low = predictor.predict_batch(points, labels, multimask_output=True,
                                               return_logits=True)
    return {"masks": masks, "ious": ious, "low": low,
            "embed": predictor.get_image_embedding().clone()}


def video_frames():
    rng = np.random.default_rng(9)
    frames = (rng.random((4, S, S, 3)) * 120).astype(np.uint8)
    for t in range(4):
        frames[t, 30 + 4 * t:70 + 4 * t, 20:60] = 230
        frames[t, 80:110, 70 + 3 * t:110 + 3 * t] = 200
    return frames


def video_predictor(mesh):
    """Two objects clicked on frame 0 and propagated over 4 frames by
    SAM2VideoPredictor(mesh=): the video-resolution logits per frame."""
    from sam2_opt_tpu_torch.models import video_core
    from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

    predictor = SAM2VideoPredictor(tiny_model(tiny_cfg()), fill_hole_area=8, mesh=mesh)
    batches, step = [], video_core.track_step_conditioned

    def counted(m, cfg, feats, mem, *args, **kwargs):
        batches.append(feats[2].shape[0])
        return step(m, cfg, feats, mem, *args, **kwargs)

    video_core.track_step_conditioned = counted
    state = predictor.init_state(video_frames())
    predictor.add_new_points_or_box(state, 0, 1, points=np.array([[40, 50]]),
                                    labels=np.array([1]))
    predictor.add_new_points_or_box(state, 0, 2, points=np.array([[90, 95]]),
                                    labels=np.array([1]))
    try:
        frames = [logits.clone() for _, _, logits in predictor.propagate_in_video(state)]
    finally:
        video_core.track_step_conditioned = step
    return {"frames": frames, "objects_per_step": batches}


def image_step(mesh, B=2):
    """`training/step.py`: (loss, whole reduced gradients, global norm) of
    one `make_train_step` step on a global batch of B images."""
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.training import step as st

    cfg = tiny_cfg()
    model = tiny_model(cfg).module
    opt = CaptureOptimizer()
    state = st.init_train_state(model, opt, mesh)
    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.random((B, S, S, 3)).astype(np.float32))
    gt = torch.zeros(B, 1, S, S)
    gt[0, :, 20:80, 30:90] = 1
    gt[1:, :, 60:120, 10:50] = 1
    _, metrics = st.make_train_step(cfg, opt, mesh)(state, images, gt)
    grads = mesh_lib.fetch_global(opt.grads, mesh, state.sharded)
    norm = opt.grad_norm if opt.grad_norm is not None else torch.sqrt(
        sum((g ** 2).sum() for g in opt.grads.values()))
    return {"loss": float(metrics["loss"]), "grads": grads, "norm": float(norm)}


def fused_mlp_refused(mesh):
    """A TP-sharded model: its "cuda" backends run eagerly (fp32 set before
    the sharding, bf16 after), and under SAM2_TPU_FUSED_MLP=1 its bf16
    encoder refuses K8, which takes whole weights."""
    sam = tiny_model(tiny_cfg())
    sam.set_runtime_backend("cuda", {"dtype": torch.float32})
    graphs = [sam._use_graphs]
    sam.shard(mesh)
    graphs.append(sam._use_graphs)
    sam.set_runtime_backend("cuda", {"dtype": torch.bfloat16})
    graphs.append(sam._use_graphs)
    saved = os.environ.get("SAM2_TPU_FUSED_MLP")
    os.environ["SAM2_TPU_FUSED_MLP"] = "1"
    refused = None
    try:
        images = torch.from_numpy(np.random.default_rng(4).random((1, 3, S, S)).astype(np.float32))
        sam.encode_image(images)
    except ValueError as e:
        refused = str(e)
    finally:
        if saved is None:
            os.environ.pop("SAM2_TPU_FUSED_MLP")
        else:
            os.environ["SAM2_TPU_FUSED_MLP"] = saved
    return {"use_graphs": graphs, "refused": refused}


# job name -> (dp, tp, fn(mesh, root)); the meshes cover the world
JOBS = {
    "dp2": (2, 1, lambda mesh, root: train_grads(mesh)),
    "tp2": (1, 2, lambda mesh, root: train_grads(mesh, B=1)),
    "dp2tp2": (2, 2, lambda mesh, root: train_grads(mesh)),
    "comms_none": (2, 1, lambda mesh, root: train_grads(mesh, clicks=False, dtype="bfloat16")),
    "comms_bf16": (2, 1, lambda mesh, root: train_grads(mesh, clicks=False, dtype="bfloat16",
                                                        comms="bfloat16")),
    "comms_raises": (1, 2, lambda mesh, root: comms_raises(mesh)),
    "cli": (2, 1, lambda mesh, root: cli(root)),
    "image_dp2": (2, 1, lambda mesh, root: image_predictor(mesh)),
    "image_tp2": (1, 2, lambda mesh, root: image_predictor(mesh)),
    "video_dp2": (2, 1, lambda mesh, root: video_predictor(mesh)),
    "k8_tp2": (1, 2, lambda mesh, root: fused_mlp_refused(mesh)),
    "step_dp2": (2, 1, lambda mesh, root: image_step(mesh)),
    "step_tp2": (1, 2, lambda mesh, root: image_step(mesh)),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world, jobs, out, timeout=240):
    """Run `jobs` on `world` ranks; raises with every rank's log tail when a
    rank fails. Returns {job: [result of rank 0, rank 1, ...]}."""
    os.makedirs(out, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", SAM2_DIST_INIT_TIMEOUT="120")
        log = open(f"{out}/rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--jobs", ",".join(jobs), "--out", out],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    failed = []
    for rank, (proc, log) in enumerate(procs):
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(rank)
    if failed:
        tails = {r: open(f"{out}/rank{r}.log").read()[-3000:] for r in range(world)}
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{t}" for r, t in tails.items()))
    return {job: [torch.load(f"{out}/{job}_{r}.pt", weights_only=False) for r in range(world)]
            for job in jobs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.init_distributed("gloo", "cpu")
    rank = torch.distributed.get_rank()
    try:
        for job in args.jobs.split(","):
            dp, tp, fn = JOBS[job]
            torch.save(fn(mesh_of(dp, tp), args.out), f"{args.out}/{job}_{rank}.pt")
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
