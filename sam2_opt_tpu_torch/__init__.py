"""sam2_opt_tpu_torch — SAM2 promptable segmentation on PyTorch and CUDA.

The PyTorch / NVIDIA H100 port of the JAX package `sam2_opt_tpu`, which stays
beside it as the reference. It covers the image predictor (the Hiera trunk
and FPN neck, the prompt encoder and the two-way mask decoder) and the video
predictor (memory attention, memory encoder and the fixed-capacity memory
bank), with the Hiera global-attention blocks on a hand-written CUDA
flash-attention kernel (K1) and memory attention on its RoPE-fused form (K2).
"""

from sam2_opt_tpu_torch.build_sam import (
    build_sam2,
    build_sam2_image_predictor,
    build_sam2_video_predictor,
)
from sam2_opt_tpu_torch.config import SAM2Config, model_config
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

__all__ = [
    "SAM2Config",
    "SAM2ImagePredictor",
    "SAM2VideoPredictor",
    "build_sam2",
    "build_sam2_image_predictor",
    "build_sam2_video_predictor",
    "model_config",
]
