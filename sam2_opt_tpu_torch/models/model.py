"""SAM2Model: the module with its fp32/bf16 runtime seam.

Counterpart of `sam2_opt_tpu/models/model.py`. It owns the fp32 master
`SAM2Base` and, after `speedup()`, a bf16 compute copy; the seams
`encode_image`, `encode_image_e2e` and `predict_masks` run on whichever is
active, and the video predictor runs `models/video_core.py` on it (`_m`).
PyTorch runs eagerly, so no seam compiles anything.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from sam2_opt_tpu_torch.config import SAM2Config, model_config
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.models.init import init_params

def default_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller names
    another device; there is no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class SAM2Model:
    """fp32 master module plus the active compute module."""

    def __init__(self, module: base.SAM2Base, cfg: SAM2Config):
        self.cfg = cfg
        self.module = module.eval()
        self.device = next(module.parameters()).device
        if self.device.type == "cuda":
            # fp32 means fp32: cuDNN would otherwise run fp32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = "eager"
        self.compute_dtype = torch.float32
        self._compute = self.module

    def set_runtime_backend(self, backend: str = "eager"):
        """'eager' = fp32 on the master module; 'cuda' = its bf16 compute
        copy (the only reduced precision the port runs). The fp32 master
        stays."""
        if backend == "eager":
            self.backend, self.compute_dtype, self._compute = "eager", torch.float32, self.module
        elif backend == "cuda":
            self.backend, self.compute_dtype = "cuda", torch.bfloat16
            self._compute = copy.deepcopy(self.module).to(torch.bfloat16)
        else:
            raise ValueError(f"unsupported backend {backend!r}: 'eager' (fp32) or 'cuda' (bf16)")

    def speedup(self, backend: str = "cuda"):
        """One-line acceleration (reference sam2_image_predictor.py:94-138):
        bf16 compute on the card. "int8" is not ported yet."""
        if backend == "int8":
            raise NotImplementedError(
                "int8 is not ported yet; see ROADMAP.md (Queue A, int8)")
        self.set_runtime_backend(backend)

    @property
    def _m(self) -> base.SAM2Base:
        return self._compute

    def _images(self, images01):
        return torch.as_tensor(images01, device=self.device).to(self.compute_dtype)

    @torch.inference_mode()
    def encode_image(self, images01):
        """[B, 3, S, S] float images in [0,1] -> (hrf0, hrf1, embed) NCHW,
        without the no-mem embedding."""
        out = base.forward_image(self._m, base.image_normalize(self._images(images01)))
        return tuple(out["backbone_fpn"])

    @torch.inference_mode()
    def encode_image_e2e(self, images01):
        """set_image path (reference sam2_image_predictor.py:252-266): encode
        and add no_mem_embed to the lowest-res map."""
        hrf0, hrf1, embed = self.encode_image(images01)
        return hrf0, hrf1, embed + self._m.no_mem_embed[0, 0].to(embed.dtype)[:, None, None]

    @torch.inference_mode()
    def predict_masks(self, embed, hrf0, hrf1, coords, labels, mask_input=None,
                      multimask_output: bool = True):
        """Prompt-encode + mask-decode (reference
        sam2_image_predictor.py:487-589). coords [B,P,2] model-frame pixels,
        labels [B,P], mask_input [B,1,256,256] or None. Returns fp32
        (low_res_masks, iou_predictions)."""
        m = self._m
        coords = torch.as_tensor(coords, dtype=torch.float32, device=self.device)
        labels = torch.as_tensor(labels, dtype=torch.int32, device=self.device)
        if mask_input is not None:
            mask_input = torch.as_tensor(mask_input, device=self.device).to(self.compute_dtype)
        sparse, dense = m.sam_prompt_encoder(coords, labels, mask_input)
        s = self.cfg.image_embedding_size
        image_pe = m.sam_prompt_encoder.get_dense_pe((s, s)).to(embed.dtype)
        masks, iou, _, _ = m.sam_mask_decoder(
            embed, image_pe, sparse.to(embed.dtype), dense.to(embed.dtype),
            multimask_output=multimask_output, high_res_features=(hrf0, hrf1),
            repeat_image=coords.shape[0] > embed.shape[0])
        return masks.float(), iou.float()


def build_sam2(variant: str = "hiera_l", checkpoint_path: Optional[str] = None,
               state_dict=None, seed: int = 0, cfg: Optional[SAM2Config] = None,
               device=None) -> SAM2Model:
    """Build a SAM2Model (reference build_sam.py:71-97 without hydra).

    Loads a reference `.pt` checkpoint or a given state_dict strictly;
    otherwise draws random weights from `seed` (on the CPU, so every device
    gets the same weights). Runs on CUDA unless `device` says otherwise.
    """
    device = default_device(device)
    if cfg is None:
        cfg = model_config(variant)
    module = base.SAM2Base(cfg)
    if checkpoint_path is not None:
        from sam2_opt_tpu_torch.io.weights import load_checkpoint

        state_dict = load_checkpoint(checkpoint_path)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    else:
        init_params(module, torch.Generator().manual_seed(seed))
    return SAM2Model(module.to(device), cfg)
