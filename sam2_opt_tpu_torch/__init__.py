"""sam2_opt_tpu_torch — SAM2 promptable segmentation on PyTorch and CUDA.

The PyTorch / NVIDIA H100 port of the JAX package `sam2_opt_tpu`, which stays
beside it as the reference. This slice covers the image predictor: the Hiera
trunk and FPN neck, the prompt encoder and the two-way mask decoder, with the
global-attention blocks on a hand-written CUDA flash-attention kernel.
"""

from sam2_opt_tpu_torch.build_sam import build_sam2, build_sam2_image_predictor
from sam2_opt_tpu_torch.config import SAM2Config, model_config
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

__all__ = [
    "SAM2Config",
    "SAM2ImagePredictor",
    "build_sam2",
    "build_sam2_image_predictor",
    "model_config",
]
