"""Inputs made on the device from the seed: videos and images.

A video is a background of random-colour blocks with textured ellipses and
rectangles that move at constant speed and bounce off the borders; the
shapes to be clicked start in separate cells of a grid, so each click on
frame 0 lands on its own shape. An image is the same kind of scene, still.
Every size and count comes from the traffic file and the unit's own seed
stream, so a given (seed, unit) always gives the same pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.compare import seed_key


def unit_rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng(seed_key(seed, stream, index))


def _blocks(gen, h, w, block, lo, hi, device):
    """uint8 [h, w, 3] of random colours in [lo, hi) on block x block cells."""
    small = torch.rand(-(-h // block), -(-w // block), 3, device=device, generator=gen)
    small = (lo + (hi - lo) * small).mul_(255.0).to(torch.uint8)
    return small.repeat_interleave(block, 0).repeat_interleave(block, 1)[:h, :w]


def _bounce(p0, v, t, lo, hi):
    """Position at time t of a point moving at v that bounces in [lo, hi]."""
    span = hi - lo
    if span <= 0:
        return lo
    x = (p0 - lo + v * t) % (2 * span)
    return lo + (x if x <= span else 2 * span - x)


def scene(rng: np.random.Generator, n_clicked: int, n_shapes: int, h: int, w: int):
    """Shape layout: per shape (height, width, ellipse?, y0, x0, vy, vx);
    the first n_clicked start in separate grid cells, the rest anywhere."""
    rows = max(1, int(np.floor(np.sqrt(n_clicked * h / w))))
    cols = -(-n_clicked // rows)
    cell_h, cell_w = h // rows, w // cols
    shapes = []
    for i in range(n_shapes):
        if i < n_clicked:
            sh = int(rng.integers(cell_h // 3, max(cell_h // 3 + 1, min(cell_h - 8, 260))))
            sw = int(rng.integers(cell_w // 3, max(cell_w // 3 + 1, min(cell_w - 8, 260))))
            r, c = divmod(i, cols)
            y0 = r * cell_h + int(rng.integers(0, max(1, cell_h - sh)))
            x0 = c * cell_w + int(rng.integers(0, max(1, cell_w - sw)))
        else:
            sh, sw = int(rng.integers(h // 12 + 1, h // 4 + 2)), int(rng.integers(w // 12 + 1,
                                                                                    w // 4 + 2))
            y0, x0 = int(rng.integers(0, h - sh)), int(rng.integers(0, w - sw))
        shapes.append((sh, sw, bool(rng.integers(0, 2)), y0, x0,
                       float(rng.uniform(-9, 9)), float(rng.uniform(-14, 14))))
    return shapes


@torch.no_grad()
def video(seed: int, stream: int, index: int, frames: int, h: int, w: int, n_clicked: int,
          n_shapes: int, device):
    """(uint8 [T, h, w, 3] on the host, [(x, y)] clicks on frame 0 at the
    clicked shapes' centres, the shapes as `scene` lays them out)."""
    rng = unit_rng(seed, stream, index)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2 ** 62)))
    bg = _blocks(gen, h, w, int(rng.integers(24, 64)), 0.0, 0.6, device)
    shapes = scene(rng, n_clicked, max(n_shapes, n_clicked), h, w)
    # clicked shapes last, so nothing covers them on frame 0
    order = list(range(n_clicked, len(shapes))) + list(range(n_clicked))
    textures, masks = {}, {}
    for i in order:
        sh, sw, ellipse = shapes[i][:3]
        textures[i] = _blocks(gen, sh, sw, int(rng.integers(8, 24)), 0.45, 1.0, device)
        if ellipse:
            yy = (torch.arange(sh, device=device)[:, None] + 0.5 - sh / 2) / (sh / 2)
            xx = (torch.arange(sw, device=device)[None, :] + 0.5 - sw / 2) / (sw / 2)
            masks[i] = (yy * yy + xx * xx <= 1.0)[..., None]
        else:
            masks[i] = None
    out = bg[None].repeat(frames, 1, 1, 1)
    for t in range(frames):
        f = out[t]
        for i in order:
            sh, sw, _, y0, x0, vy, vx = shapes[i]
            y = int(round(_bounce(y0, vy, t, 0, h - sh)))
            x = int(round(_bounce(x0, vx, t, 0, w - sw)))
            region = f[y:y + sh, x:x + sw]
            region.copy_(textures[i] if masks[i] is None
                         else torch.where(masks[i], textures[i], region))
    clicks = [(shapes[i][4] + shapes[i][1] / 2.0, shapes[i][3] + shapes[i][0] / 2.0)
              for i in range(n_clicked)]
    return out.cpu().numpy(), clicks, shapes
