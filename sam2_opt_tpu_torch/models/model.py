"""SAM2Model: the module with its fp32/bf16 runtime seam.

Counterpart of `sam2_opt_tpu/models/model.py`. It owns the fp32 master
`SAM2Base` and, after `speedup()`, a bf16 compute copy (after
`speedup("int8")` a copy whose linears are int8, `quant/int8.py`); the seams
`encode_image`, `encode_image_e2e` and `predict_masks` run on whichever is
active, and the video predictor runs `models/video_core.py` on it (`_m`).
Under the "cuda" backend every seam, the video predictor's tracking steps
included, runs through `core/executor.py`: one CUDA graph per input
signature, as the JAX package's `speedup()` compiles one XLA executable per
signature (`_get_jit`); "eager" runs op by op in fp32.

The same class runs a Segment Anything ViT model (`models/vit.py`, a
`config.SamViTConfig`): its `encode_image_e2e` returns the one image
embedding, and `predict_masks` decodes without high-resolution features.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Optional

import torch

from sam2_opt_tpu_torch.config import SAM2Config, SamViTConfig, is_vit_variant, model_config, \
    sam_vit_config
from sam2_opt_tpu_torch.core.executor import GraphExecutor, seam_name
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.models import vit
from sam2_opt_tpu_torch.models.init import init_params
from sam2_opt_tpu_torch.utils import profiling

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
        # the set_image seam: a Segment Anything ViT model's (`models/vit.py`)
        # returns its one embedding
        self._encode = vit.encode_e2e if isinstance(cfg, SamViTConfig) else encode_e2e
        self.module = module.eval()
        self.device = next(module.parameters()).device
        if self.device.type == "cuda":
            # fp32 means fp32: cuDNN would otherwise run fp32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = "eager"
        self.compute_dtype = torch.float32
        self._compute = self.module
        # bounded (SAM2_TPU_JIT_CACHE_SIZE): a long-lived server would
        # otherwise keep a graph per video resolution and object count
        self.graphs = GraphExecutor()
        # set by set_runtime_backend; chip_smoke.py and the tests turn it off
        # after a "cuda" backend to run the same dtype eagerly, the yardstick
        # a graph is held against
        self._use_graphs = False
        # set by shard(): the ("data", "model") mesh and {name: dim} of the
        # parameters that are tensor-parallel shards
        self.mesh = None
        self.sharded = {}

    def shard(self, mesh) -> "SAM2Model":
        """Tensor-parallel placement (JAX `models/model.py:51-66`): each
        linear the TP rule selects keeps this rank's rows of the "model"
        axis (`parallel/tp.py`); the predictors split their batches over
        "data". Beyond the reference, which runs inference on one GPU. Shard
        before `speedup()`: the compute copies are made from the master. A
        sharded model runs its seams eagerly (no CUDA graphs)."""
        from sam2_opt_tpu_torch.parallel import tp as tp_lib

        if self.mesh is not None:
            if mesh is self.mesh:
                return self
            raise RuntimeError("the model is already sharded over another mesh")
        if self._compute is not self.module:
            raise RuntimeError("shard() before speedup(): the compute copy would keep whole "
                               "weights")
        self.mesh = mesh
        self.sharded = tp_lib.shard_module(self.module, mesh)
        # a float32 "cuda" backend computes on the master: its seams now run
        # eagerly (set_runtime_backend)
        self._use_graphs = self._use_graphs and not self.sharded
        self.graphs.clear()
        return self

    def set_runtime_backend(self, backend: str = "eager", args: Optional[dict] = None):
        """'eager' = fp32 op by op on the master module; 'cuda' = the seams
        as CUDA graph replays (core/executor.py) in `args["dtype"]`:
        bfloat16 (the default, a compute copy; the fp32 master stays) or
        float32 (the master itself; `quantize_int8` quantizes a copy). A
        model with tensor-parallel shards runs that dtype eagerly: a graph
        cannot capture the collectives of its linears over gloo. The graphs
        are cleared on every change, as the JAX package clears `_jit_fns`."""
        args = dict(args or {})
        if backend == "eager":
            self.backend, self.compute_dtype, self._compute = "eager", torch.float32, self.module
            self._use_graphs = False
        elif backend == "cuda":
            dtype = args.get("dtype", torch.bfloat16)
            if dtype not in (torch.bfloat16, torch.float32):
                raise ValueError(f"unsupported dtype {dtype}: bfloat16 or float32")
            self.backend, self.compute_dtype = "cuda", dtype
            self._compute = (self.module if dtype == torch.float32
                             else copy.deepcopy(self.module).to(torch.bfloat16))
            self._use_graphs = not self.sharded
        else:
            raise ValueError(f"unsupported backend {backend!r}: 'eager' (fp32) or 'cuda'")
        self.graphs.clear()

    def speedup(self, backend: str = "cuda", dtype=torch.bfloat16,
                calib_dir: Optional[str] = None, model_root_path: Optional[str] = None,
                activation_quant: bool = True, quant_scope: str = "encoder",
                max_images: Optional[int] = 32):
        """One-line acceleration (reference sam2_image_predictor.py:94-138):
        `dtype` compute on the card, every seam a CUDA graph replay.

        backend "int8" (aliases "trt_int8"/"int8_trt": the reference's
        `speedup("trt", model_root_path=...)` int8 engines,
        benchmark.py:172-174) also quantizes the linears of `quant_scope`
        ("encoder" or "tracking", `quantize_int8`): weight-only without a
        calibration directory, activation-quant when `calib_dir` (or
        `model_root_path`, accepted for the reference's call sites) holds
        calibration images. The fp32 master stays: speedup("eager")
        restores the parity path."""
        backend = str(backend).lower()
        if backend in ("int8", "trt_int8", "int8_trt"):
            self.quantize_int8(calib_dir=calib_dir or model_root_path,
                               activation_quant=activation_quant, dtype=dtype,
                               scope=quant_scope, max_images=max_images)
            return
        if calib_dir is not None or model_root_path is not None:
            import logging

            logging.getLogger(__name__).warning(
                "speedup(%r): model_root_path/calib_dir ignored (they select int8); "
                "for int8 use speedup('int8', calib_dir=...)", backend)
        self.set_runtime_backend(backend, {"dtype": dtype} if backend == "cuda" else None)

    def quantize_int8(self, calib_dir: Optional[str] = None, activation_quant: bool = True,
                      dtype=torch.bfloat16, pattern: Optional[str] = None,
                      max_images: Optional[int] = None, scope: str = "encoder"):
        """Int8-quantize the hot path (JAX `models/model.py:137-197`, the
        stand-in for the reference's TRT int8 engines,
        quant_image_encoder.py:8-75) on the "cuda" backend in `dtype`.
        Quantizes a compute copy only: in fp32 too the master module is
        left as it is.

        scope: "encoder" (the reference's int8 footprint: the Hiera trunk's
        linears) or "tracking" (beyond the reference: also memory
        attention's q/k/v/out projections and FFN and the two-way
        transformer's linears; calibration then drives the whole tracking
        step per image). With `activation_quant` and `calib_dir`, at most
        `max_images` images (32 when None; 0 or below: no cap) calibrate
        the activation scales on the fp32 master, eagerly."""
        from sam2_opt_tpu_torch.quant.int8 import (
            DEFAULT_QUANT_PATTERN,
            TRACKING_QUANT_PATTERN,
            quantize_module,
        )

        if self.sharded:
            raise ValueError("int8 quantizes whole linears; a tensor-parallel model holds shards")
        if scope not in ("encoder", "tracking"):
            # scope also selects the calibration routine, so a typo must not
            # calibrate the encoder alone
            raise ValueError(f"unknown quant scope: {scope!r}")
        if pattern is None:
            pattern = TRACKING_QUANT_PATTERN if scope == "tracking" else DEFAULT_QUANT_PATTERN
        act_scales = None
        if activation_quant and calib_dir:
            from sam2_opt_tpu_torch.quant import calibrate as cal

            if max_images is None:
                max_images = 32
            ds = cal.ImageEncodeCalibratorDataset(
                calib_dir, image_size=self.cfg.image_size,
                max_images=max_images if max_images > 0 else None)
            collect = (cal.collect_tracking_activation_scales if scope == "tracking"
                       else cal.collect_activation_scales)
            act_scales = collect(self.module, self.cfg, ds.batches(), pattern=pattern)
            if not act_scales:
                raise RuntimeError(
                    f"activation calibration over {calib_dir!r} produced no scales (quant "
                    f"pattern {pattern!r} matched no linears); refusing to fall back to "
                    f"weight-only int8 silently.")
        self.set_runtime_backend("cuda", {"dtype": dtype})
        if self._compute is self.module:
            self._compute = copy.deepcopy(self.module)
        quantize_module(self._compute, pattern, act_scales)
        self.graphs.clear()

    def run(self, name, fn, args: tuple):
        """fn(*args): a graph replay per signature under the "cuda" backend
        (eager on CPU tensors), otherwise a plain call. `name` holds the
        static flags that select what fn computes. With the tracer on, the
        call is the span `seam:<name>`, and an eager call on the card records
        its stage events too."""
        if not profiling.enabled():
            return self.graphs.run(name, fn, args) if self._use_graphs else fn(*args)
        seam = seam_name(name)
        with profiling.span("seam", seam):
            if self._use_graphs:
                return self.graphs.run(name, fn, args)
            if self.device.type != "cuda":
                return fn(*args)
            events, t = [], time.perf_counter()
            with profiling.TRACER.collect(events):
                out = fn(*args)
            profiling.TRACER.launched(seam, t, events)
            return out

    @property
    def _m(self) -> base.SAM2Base:
        return self._compute

    def _images(self, images01):
        with profiling.span("image.resize"):
            return torch.as_tensor(images01, device=self.device).to(self.compute_dtype)

    @torch.inference_mode()
    def encode_image(self, images01):
        """[B, 3, S, S] float images in [0,1] -> (hrf0, hrf1, embed) NCHW,
        without the no-mem embedding."""
        return self.run("encode_image", functools.partial(encode, self._m),
                        (self._images(images01),))

    @torch.inference_mode()
    def encode_image_e2e(self, images01):
        """set_image path (reference sam2_image_predictor.py:252-266): encode
        and add no_mem_embed to the lowest-res map. A SAM ViT model takes
        images the predictor has normalized and padded and returns its one
        embedding (reference segment_anything/predictor.py:80-88)."""
        return self.run("encode_image_e2e", functools.partial(self._encode, self._m),
                        (self._images(images01),))

    @torch.inference_mode()
    def predict_masks(self, embed, hrf0, hrf1, coords, labels, mask_input=None,
                      multimask_output: bool = True, pad: bool = True):
        """Prompt-encode + mask-decode (reference
        sam2_image_predictor.py:487-589). coords [B,P,2] model-frame pixels,
        labels [B,P], mask_input [B,1,256,256] or None; hrf0/hrf1 None for a
        SAM ViT model; `pad` appends the padding point (SAM: only without a
        box). Returns fp32 (low_res_masks, iou_predictions)."""
        with profiling.span("predict.prompts"):
            coords = torch.as_tensor(coords, dtype=torch.float32, device=self.device)
            labels = torch.as_tensor(labels, dtype=torch.int32, device=self.device)
            if mask_input is not None:
                mask_input = torch.as_tensor(mask_input,
                                             device=self.device).to(self.compute_dtype)
        fn = functools.partial(decode_masks, self._m, self.cfg,
                               multimask_output=multimask_output, pad=pad)
        return self.run(("predict_masks", multimask_output, mask_input is not None, pad), fn,
                        (embed, hrf0, hrf1, coords, labels, mask_input))


def encode(m: base.SAM2Base, images):
    """The encoder seam: [B, 3, S, S] images in [0, 1] -> (hrf0, hrf1,
    embed) NCHW."""
    return tuple(base.forward_image(m, base.image_normalize(images))["backbone_fpn"])


def encode_e2e(m: base.SAM2Base, images):
    """The `set_image` seam: `encode`, with no_mem_embed added to the
    lowest-res map."""
    hrf0, hrf1, embed = encode(m, images)
    return hrf0, hrf1, embed + m.no_mem_embed[0, 0].to(embed.dtype)[:, None, None]


def decode_masks(m: base.SAM2Base, cfg: SAM2Config, embed, hrf0, hrf1, coords, labels,
                 mask_input=None, multimask_output: bool = True, pad: bool = True):
    """The prompt-encode + mask-decode seam: fp32 (low_res_masks,
    iou_predictions). Stages (`utils/profiling.py`): `prompt_encoder` (the
    dense positional encoding included), `mask_decoder`."""
    sparse, dense = m.sam_prompt_encoder(coords, labels, mask_input, pad=pad)
    s = cfg.image_embedding_size
    image_pe = m.sam_prompt_encoder.get_dense_pe((s, s)).to(embed.dtype)
    profiling.stage("prompt_encoder", image_pe)
    masks, iou, _, _ = m.sam_mask_decoder(
        embed, image_pe, sparse.to(embed.dtype), dense.to(embed.dtype),
        multimask_output=multimask_output,
        high_res_features=None if hrf0 is None else (hrf0, hrf1),
        repeat_image=coords.shape[0] > embed.shape[0])
    profiling.stage("mask_decoder", masks)
    return masks.float(), iou.float()


def build_sam2(variant: str = "hiera_l", checkpoint_path: Optional[str] = None,
               state_dict=None, seed: int = 0, cfg: Optional[SAM2Config] = None,
               device=None) -> SAM2Model:
    """Build a SAM2Model (reference build_sam.py:71-97 without hydra).

    Loads a reference `.pt` checkpoint or a given state_dict strictly (an
    int8 one, such as a JAX int8 tree carried across, gives a module whose
    linears are int8); otherwise draws random weights from `seed` (on the
    CPU, so every device gets the same weights). Runs on CUDA unless
    `device` says otherwise. "vit_h", "vit_l" and "vit_b" (or a
    `SamViTConfig`) build Segment Anything (`models/vit.py`).
    """
    device = default_device(device)
    if cfg is None:
        cfg = sam_vit_config(variant) if is_vit_variant(variant) else model_config(variant)
    module = vit.SamViT(cfg) if isinstance(cfg, SamViTConfig) else base.SAM2Base(cfg)
    if checkpoint_path is not None:
        from sam2_opt_tpu_torch.io.weights import load_checkpoint

        state_dict = load_checkpoint(checkpoint_path)
    if state_dict is not None:
        from sam2_opt_tpu_torch.quant.int8 import quantize_like

        quantize_like(module, state_dict)  # an int8 state dict's layers
        module.load_state_dict(state_dict, strict=True)
    else:
        init_params(module, torch.Generator().manual_seed(seed))
    return SAM2Model(module.to(device), cfg)
