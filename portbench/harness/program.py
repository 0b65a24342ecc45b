"""The system under test, built from a benchmark configuration: the port's
model holding the seed's weights, through the user's entry points."""

from __future__ import annotations

import torch

from portbench.harness import weights
from portbench.reference import sam2_ref


def reference_config(config: dict) -> sam2_ref.Config:
    return sam2_ref.config_from_json(config["model"])


def state_dict(ctx) -> dict:
    """The weights from the seed, with the configuration's adjustments."""
    assumed = ctx.config.get("assumed", {})
    return weights.make_state_dict(reference_config(ctx.config), ctx.seed, ctx.device,
                                   assumed.get("state_dict_add"), assumed.get("state_dict_scale"))


def _mismatches(program_cfg, model: dict, path=""):
    """Keys of the configuration file whose value the port's config does
    not hold."""
    out = []
    for key, want in model.items():
        have = getattr(program_cfg, key, None)
        if isinstance(want, dict):
            out += _mismatches(have, want, f"{path}{key}.")
        elif (list(have) if isinstance(have, (tuple, list)) else have) != want:
            out.append(f"{path}{key}: file {want!r}, port {have!r}")
    return out


def build_model(ctx, sd: dict):
    """The port's SAM2Model for `config` ("variant" names the port's
    preset, "overrides" any fields changed from it), holding `sd`; refuses
    a configuration that differs from the file."""
    from sam2_opt_tpu_torch.build_sam import build_sam2
    from sam2_opt_tpu_torch.config import model_config

    config, device = ctx.config, ctx.device
    ctx.mark("weights")
    if device.type == "cuda":  # nvcc on a checkout's first run, else nothing
        from sam2_opt_tpu_torch.kernels import _build

        _build.build_all()
        ctx.mark("kernels built")
    port_cfg = model_config(config["variant"], **config.get("overrides", {}))
    with torch.device(device):
        model = build_sam2(config["variant"], state_dict=sd, device=device, cfg=port_cfg)
    bad = _mismatches(model.cfg, config["model"])
    if bad:
        raise ValueError("the port's configuration differs from the benchmark's file: "
                         + "; ".join(bad))
    ctx.mark("model built")
    return model


def speedup(ctx, predictor):
    """The configuration's precision through `speedup()` (the fp8 control
    replaces the port's answers later, after the window)."""
    if ctx.config["dtype"] != "bfloat16":
        raise ValueError(f"unsupported dtype {ctx.config['dtype']!r}")
    predictor.speedup()
    ctx.mark("speedup")
