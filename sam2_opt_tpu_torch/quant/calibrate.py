"""Int8 activation calibration.

Counterpart of `sam2_opt_tpu/quant/calibrate.py`, after the reference's
calibrator/image_encode.py (:1-107): load up to `max_images` jpg/png
calibration images, resize them to the model resolution, scale to [0,1]
(ImageNet normalization optional, off for the graph that normalizes
inside), run the model with activation capture and turn each matching
linear's recorded input absmax into a per-tensor scale, in place of the TRT
entropy calibrator.

The capture is a forward pre-hook on every matching `nn.Linear`. Memory
attention's q and k projections run on split copies of their weights and
K4 reads the raw k/v weights (`models/memory_attention.py`), so there the
call sites run the projection's pre-hooks on its input themselves.
Calibration runs eagerly on the fp32 master module: hooks do not run inside
a CUDA graph replay.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from sam2_opt_tpu_torch.quant.int8 import DEFAULT_QUANT_PATTERN


class ImageEncodeCalibratorDataset:
    """Calibration image pipeline (reference calibrator/image_encode.py:10-107);
    a copy of the JAX package's: the same files give the same arrays."""

    def __init__(self, images_path: str, batch_size: int = 1,
                 image_size: int = 1024, do_norm: bool = False,
                 max_images: Optional[int] = 2000):
        # max_images=None means no cap (the [:None] slice keeps everything)
        self.image_size = image_size
        self.do_norm = do_norm
        names = [
            p for p in sorted(os.listdir(images_path))
            if os.path.splitext(p)[-1].lower() in (".jpg", ".jpeg", ".png")
        ][:max_images]
        self.paths = [os.path.join(images_path, p) for p in names]
        if not self.paths:
            raise ValueError(
                f"no calibration images (.jpg/.jpeg/.png) found in "
                f"{images_path!r}: activation-quant int8 needs a directory of "
                f"images (reference calibrator/image_encode.py:84-107). For "
                f"weight-only int8 pass activation_quant=False instead."
            )
        self.batch_size = batch_size

    def __len__(self):
        return len(self.paths) // self.batch_size

    def preprocess(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize(
            (self.image_size, self.image_size), Image.BILINEAR
        )
        x = np.asarray(img, np.float32) / 255.0
        if self.do_norm:
            x = (x - np.asarray([0.485, 0.456, 0.406])) / np.asarray(
                [0.229, 0.224, 0.225]
            )
        return x.astype(np.float32)

    def batches(self):
        """[B, S, S, 3] float32 arrays (HWC, as the JAX package's)."""
        for i in range(len(self)):
            chunk = self.paths[i * self.batch_size : (i + 1) * self.batch_size]
            yield np.stack([self.preprocess(p) for p in chunk])


class _LinearCapture:
    """Forward pre-hooks on every `nn.Linear` of `module` whose
    `name + ".weight"` matches `pattern`, recording the input's absmax per
    call; removed on exit."""

    def __init__(self, module: nn.Module, pattern: str):
        self.module = module
        self.rx = re.compile(pattern)
        self.records: Dict[str, List[float]] = {}
        self._handles = []

    def __enter__(self):
        for name, sub in self.module.named_modules():
            key = name + ".weight"
            if isinstance(sub, nn.Linear) and sub.weight.ndim == 2 and self.rx.search(key):
                def hook(mod, args, key=key):
                    self.records.setdefault(key, []).append(float(args[0].detach().abs().amax()))
                self._handles.append(sub.register_forward_pre_hook(hook))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles.clear()
        return False

    def scales(self, percentile: float) -> Dict[str, float]:
        """{weight name: scale}: the records' `percentile` where a layer has
        more than 4, else their max; at least 1e-6, over 127."""
        out = {}
        for name, vals in self.records.items():
            v = (np.percentile(np.asarray(vals), percentile)
                 if len(vals) > 4 else max(vals))
            out[name] = float(max(v, 1e-6) / 127.0)
        return out


def _images(module: nn.Module, batch: np.ndarray) -> torch.Tensor:
    """[B, S, S, 3] HWC floats -> [B, 3, S, S] on the module's device, fp32."""
    device = next(module.parameters()).device
    return torch.as_tensor(batch, device=device).permute(0, 3, 1, 2).float()


@torch.inference_mode()
def collect_activation_scales(module: nn.Module, cfg, batches,
                              pattern: str = DEFAULT_QUANT_PATTERN,
                              percentile: float = 99.99) -> Dict[str, float]:
    """Run the encoder over calibration batches, recording the input
    absmax of every linear that will be quantized. Returns
    {dotted weight name: per-tensor scale}."""
    from sam2_opt_tpu_torch.models import sam2_base as base

    with _LinearCapture(module, pattern) as cap:
        for batch in batches:
            base.forward_image(module, base.image_normalize(_images(module, batch)))
    return cap.scales(percentile)


@torch.inference_mode()
def collect_tracking_activation_scales(module: nn.Module, cfg, batches, pattern: str,
                                       percentile: float = 99.99) -> Dict[str, float]:
    """Activation scales for the tracking hot path (memory attention, SAM
    heads and the encoder), which the reference never quantizes. Each
    calibration image runs eagerly through: encode, an init step (a centre
    click, memory encoded), then one conditioned step against a
    full-capacity memory bank built from that frame's own memory and
    pointer (every slot and pointer valid: the steady state)."""
    from sam2_opt_tpu_torch.models import sam2_base as base
    from sam2_opt_tpu_torch.models import video_core as vc

    S_img = cfg.image_size
    with _LinearCapture(module, pattern) as cap:
        for batch in batches:
            img = _images(module, batch)
            B, device = img.shape[0], img.device
            feats = tuple(base.forward_image(module, base.image_normalize(img))["backbone_fpn"])
            coords = torch.full((B, 1, 2), S_img / 2.0, device=device)
            labels = torch.ones(B, 1, dtype=torch.int32, device=device)
            init = vc.track_step_init(module, cfg, feats, coords, labels, None,
                                      multimask_output=True, run_mem_encoder=True)
            S, P = cfg.num_maskmem, cfg.max_obj_ptrs_in_encoder
            mm, ptr = init["maskmem_features"], init["obj_ptr"]
            mem = vc.MemoryInput(
                feats=(mm,) * S,
                tpos_idx=torch.arange(S, device=device)[None].expand(B, S),
                valid=torch.ones(B, S, dtype=torch.bool, device=device),
                ptrs=(ptr,) * P,
                ptr_pos=(torch.arange(P, device=device, dtype=torch.float32)
                         / max(P - 1, 1))[None].expand(B, P),
                ptr_valid=torch.ones(B, P, dtype=torch.bool, device=device))
            vc.track_step_conditioned(module, cfg, feats, mem, multimask_output=True,
                                      run_mem_encoder=True)
    return cap.scales(percentile)


def quantize_model(model, images_path: Optional[str] = None,
                   pattern: str = DEFAULT_QUANT_PATTERN,
                   activation_quant: bool = False, max_images: int = 32):
    """One-call int8 quantization of a SAM2Model (the quant_image_encoder.py
    equivalent). Weight-only unless `images_path` is given and
    `activation_quant`. A thin wrapper over `SAM2Model.quantize_int8`: it
    quantizes a compute copy (the fp32 master stays, so speedup("eager")
    restores the parity path), raises if calibration yields no scales, and
    calibrates on at most `max_images` images."""
    model.quantize_int8(
        calib_dir=images_path if activation_quant else None,
        activation_quant=activation_quant,
        pattern=pattern,
        max_images=max_images,
    )
    return model
