"""Image demo (counterpart of `examples/image.py`; reference image.py:1-39):
build -> speedup() -> set_image -> predict with 2 points, save the blended
best mask as a PNG.

    python -m sam2_opt_tpu_torch.examples.image IMAGE [--checkpoint ckpt.pt]
        [--variant hiera_l] [--output_dir outputs/image_demo] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from sam2_opt_tpu_torch import build_sam2_image_predictor
from sam2_opt_tpu_torch.examples.draw import gen_image_writer, save_masks

POINTS = np.array([[500, 375], [1125, 625]], np.float32)


def main(image_path, checkpoint=None, variant="hiera_l", output_dir="outputs/image_demo",
         device=None):
    """Returns the masks and IoU predictions of the two-point prompt. On
    the card the predictor runs `speedup()` (bf16 CUDA graphs), elsewhere
    fp32 eagerly; without a checkpoint the weights are random (seed 0)."""
    from PIL import Image

    predictor = build_sam2_image_predictor(variant, checkpoint, device=device)
    if predictor.device.type == "cuda":
        predictor.speedup()

    image = np.array(Image.open(image_path).convert("RGB"))
    predictor.set_image(image)
    masks, ious, _ = predictor.predict(point_coords=POINTS,
                                       point_labels=np.array([1, 1], np.int32))
    print("masks:", masks.shape, "ious:", ious)

    save_masks(image, [masks[int(np.argmax(ious))]], gen_image_writer(output_dir))
    print(f"saved to {output_dir}")
    return masks, ious


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("image_path")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--variant", default="hiera_l")
    parser.add_argument("--output_dir", default="outputs/image_demo")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()
    main(args.image_path, args.checkpoint, args.variant, args.output_dir, args.device)


if __name__ == "__main__":
    cli()
