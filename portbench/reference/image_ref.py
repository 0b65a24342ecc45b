"""Plain fp32 image prediction: `set_image` and `predict` as the upstream
image predictor runs them (sam2_image_predictor.py:94-589, transforms.py):
a bilinear antialiased resize to the model's square input, the image
encoder with the no-memory embedding added to the lowest-resolution map,
then per prompt the prompt encoder, the mask decoder, and a bilinear resize
of the low-res logits to the image's resolution."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import sam2_ref as ref


class ImageRef:
    def __init__(self, model: ref.SAM2, device):
        self.model, self.device = model, device

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        S = self.model.cfg.image_size
        x = torch.from_numpy(image).to(self.device).permute(2, 0, 1)[None].float() / 255.0
        x = F.interpolate(x, size=(S, S), mode="bilinear", align_corners=False, antialias=True)
        self.hw = image.shape[:2]
        self.hrf0, self.hrf1, embed = self.model.encode(x)
        self.embed = embed + self.model.no_mem_embed[0, 0][:, None, None]

    @torch.no_grad()
    def predict(self, point_coords=None, point_labels=None, box=None, mask_input=None,
                multimask_output: bool = True):
        """(masks logits [M, H, W], ious [M], low-res logits [M, 256, 256]) on
        the device; coordinates in image pixels, `mask_input` [1, 256, 256]."""
        m, S = self.model, self.model.cfg.image_size
        h, w = self.hw
        scale = torch.tensor([S / w, S / h], dtype=torch.float32, device=self.device)
        coords, labels = [], []
        if box is not None:
            coords.append(torch.as_tensor(np.asarray(box, np.float32).reshape(2, 2),
                                          device=self.device) * scale)
            labels.append(torch.tensor([2, 3], device=self.device))
        if point_coords is not None:
            coords.append(torch.as_tensor(np.asarray(point_coords, np.float32),
                                          device=self.device) * scale)
            labels.append(torch.as_tensor(np.asarray(point_labels), device=self.device))
        coords, labels = torch.cat(coords)[None], torch.cat(labels).long()[None]
        mask = None if mask_input is None else torch.as_tensor(
            mask_input, dtype=torch.float32, device=self.device)[None]
        sparse, dense = m.sam_prompt_encoder(coords, labels, mask)
        masks, ious, _, _ = m.sam_mask_decoder(self.embed, m.sam_prompt_encoder.dense_pe(),
                                               sparse, dense, multimask_output, self.hrf0,
                                               self.hrf1)
        # without multimask, how far the single mask's stability lay from the
        # threshold that chose between it and the best candidate
        self.margin = None if multimask_output else abs(
            m.sam_mask_decoder.last_stability.min().item()
            - m.cfg.dynamic_multimask_stability_thresh)
        return ref.resize(masks, (h, w))[0], ious[0], masks[0].clamp(-32.0, 32.0)
