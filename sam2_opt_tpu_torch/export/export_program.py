"""Offline graph export: `torch.export` programs of the compiled seams.

The counterpart of `sam2_opt_tpu/export/export_stablehlo.py`, which writes
each seam as serialized StableHLO through `jax.export` with its Pallas calls
inside. Here each seam is one `torch.export.export(..., strict=False)` at
static shapes, the parameters cast to `dtype` and held in the program,
saved with `torch.export.save` as `<seam>.pt2`. Every kernel is a
registered operator (`sam2_opt_tpu_torch::...`, `kernels/_build.py`), so a
program holds each kernel call as one node and launches the hand-written
kernel through the same wrapper when it runs on the card (its plain version
on the CPU). The `SAM2_TPU_*` route switches are read while a seam is
traced and baked into its program, as `jax.export` bakes them in.

Loading needs the operators registered and, for `track_step`, the type its
input spec names (`MemoryInput`, registered as `sam2_opt_tpu_torch.MemoryInput`):
`load_exported` imports both, so

    from sam2_opt_tpu_torch.export.export_program import load_exported
    program = load_exported("exported/track_step.pt2")
    masks, obj_ptr, score, maskmem = program.module()(f0, f1, f2, mem)

CLI:
    python -m sam2_opt_tpu_torch.export.export_program --variant hiera_l \
        --checkpoint ckpt.pt --out_dir exported/ [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Dict

import torch
from torch import nn
from torch.export.graph_signature import ExportGraphSignature, InputKind
from torch.utils import _pytree

# the operators every program may call, registered on import
from sam2_opt_tpu_torch.kernels import _build
from sam2_opt_tpu_torch.kernels import flash_attention as _flash  # noqa: F401
from sam2_opt_tpu_torch.kernels import fused_mlp as _mlp  # noqa: F401
from sam2_opt_tpu_torch.kernels import window_attention as _window  # noqa: F401
from sam2_opt_tpu_torch.models import model as model_lib
from sam2_opt_tpu_torch.models import video_core as vc

SEAMS = ("set_image_e2e", "track_step", "memory_encoder", "predict_masks")

if vc.MemoryInput not in _pytree.SUPPORTED_NODES:
    _pytree._register_namedtuple(vc.MemoryInput,
                                 serialized_type_name="sam2_opt_tpu_torch.MemoryInput")
# a program keeps its example inputs, which `torch.export.load` unpickles
torch.serialization.add_safe_globals([vc.MemoryInput])


def set_image_e2e(m, cfg, img):
    """Normalize, encode, no_mem_embed: (hrf0, hrf1, embed) NCHW."""
    return model_lib.encode_e2e(m, img)


def track_step(m, cfg, f0, f1, f2, mem):
    """A conditioned track step (memory attention, SAM heads, memory
    encoder), multimask, no hole filling."""
    o = vc.track_step_conditioned(m, cfg, (f0, f1, f2), mem, multimask_output=True,
                                  run_mem_encoder=True)
    return o["pred_masks"], o["obj_ptr"], o["object_score_logits"], o["maskmem_features"]


def memory_encoder(m, cfg, f2, high_res_masks, obj_score):
    return vc.encode_memory_only(m, cfg, f2, high_res_masks, obj_score, is_mask_from_pts=False)


def predict_masks(m, cfg, embed, f0, f1, coords, labels):
    """Prompt-encode + mask-decode (one point, multimask)."""
    return model_lib.decode_masks(m, cfg, embed, f0, f1, coords, labels)


class Seam(nn.Module):
    """One seam as a module that holds the model, so `torch.export` keeps
    its parameters in the program."""

    def __init__(self, module, cfg, fn):
        super().__init__()
        self.model = module
        self.cfg = cfg
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, self.cfg, *args)


def example_inputs(cfg, dtype, device, ptr_cap: int = 0):
    """{seam: args}: zeros at the shapes `export_stablehlo.py` exports,
    in the port's NCHW layout. The track step's `MemoryInput` has
    `num_maskmem` slots and `ptr_cap or max_obj_ptrs_in_encoder` pointers in
    the batched [1, S] / [1, P] layout the predictor gathers."""
    S, g, C = cfg.image_size, cfg.image_embedding_size, cfg.hidden_dim
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    P = ptr_cap or cfg.max_obj_ptrs_in_encoder
    mem = vc.MemoryInput(
        feats=tuple(z(1, cfg.mem_dim, g, g, dt=torch.bfloat16) for _ in range(cfg.num_maskmem)),
        tpos_idx=z(1, cfg.num_maskmem, dt=torch.long),
        valid=z(1, cfg.num_maskmem, dt=torch.bool),
        ptrs=tuple(z(1, C, dt=torch.float32) for _ in range(P)),
        ptr_pos=z(1, P, dt=torch.float32),
        ptr_valid=z(1, P, dt=torch.bool))
    feats = (z(1, C // 8, 4 * g, 4 * g), z(1, C // 4, 2 * g, 2 * g), z(1, C, g, g))
    return {
        "set_image_e2e": (z(1, 3, S, S),),
        "track_step": (*feats, mem),
        "memory_encoder": (feats[2], z(1, 1, S, S, dt=torch.float32),
                           z(1, 1, dt=torch.float32)),
        "predict_masks": (feats[2], feats[0], feats[1], z(1, 1, 2, dt=torch.float32),
                          z(1, 1, dt=torch.int32)),
    }


def compute_module(model, dtype):
    """The fp32 master cast to `dtype`, as the programs hold it."""
    module = copy.deepcopy(model.module).to(dtype).eval()
    module.requires_grad_(False)
    return module


def export_all(model, out_dir: str, dtype=torch.bfloat16, ptr_cap: int = 0) -> Dict[str, str]:
    """Export the four seams of `model` (a `SAM2Model`) with its parameters
    cast to `dtype` and held in each program: `set_image_e2e` (normalize,
    encoder, no_mem_embed), `track_step` (a conditioned track step), the
    memory encoder and `predict_masks`. Returns {seam: path of its .pt2}.
    Sessions with 2 or more past conditioning frames grow the pointers in
    buckets of 8 at run time: export again with a larger `ptr_cap` to serve
    those shapes."""
    os.makedirs(out_dir, exist_ok=True)
    module = compute_module(model, dtype)
    device = next(module.parameters()).device
    inputs = example_inputs(model.cfg, dtype, device, ptr_cap)
    out = {}
    for name in SEAMS:
        out[name] = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(export_seam(module, model.cfg, name, inputs[name]), out[name])
    return out


def export_seam(module, cfg, name: str, args):
    """One seam of `module` (a `SAM2Base`, see `compute_module`) traced at
    the shapes of `args` (see `example_inputs`): its program, holding the
    parameters its graph reads. The seam runs once eagerly first, so the
    per-shape constants it caches (`ops.constant_cache`) are real tensors,
    which the program holds once each. Both run without grad, as the
    seams run in inference, so the trace takes the routes an inference
    takes (the bf16 trunk's `add_layer_norm`)."""
    seam = Seam(module, cfg, globals()[name])
    with torch.no_grad():
        seam(*args)
        program = torch.export.export(seam, args, strict=False)
    return _without_unused_state(program)


def _without_unused_state(program):
    """The program without the parameters and buffers its graph never
    reads: `torch.export` lifts every parameter of the model, and each seam
    reads a part of it."""
    graph = program.graph_module.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    keep, drop = [], set()
    for spec, node in zip(program.graph_signature.input_specs, placeholders):
        if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER) and not node.users:
            graph.erase_node(node)
            drop.add(spec.target)
        else:
            keep.append(spec)
    return torch.export.ExportedProgram(
        root=program.graph_module, graph=graph,
        graph_signature=ExportGraphSignature(keep, program.graph_signature.output_specs),
        state_dict={k: v for k, v in program.state_dict.items() if k not in drop},
        range_constraints=program.range_constraints, module_call_graph=program.module_call_graph,
        example_inputs=program.example_inputs, constants=program.constants,
        verifiers=program.verifiers)


def load_exported(path: str):
    """The saved program (`torch.export.ExportedProgram`); call
    `.module()(*args)`. This module registers the operators and
    `MemoryInput` it needs."""
    return torch.export.load(path)


def kernel_nodes(program) -> Dict[str, int]:
    """{operator: call nodes} of the kernels' operators in a program's graph."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        target = node.target
        if node.op == "call_function" and getattr(target, "namespace", None) == _build.NAMESPACE:
            name = target.name().split("::")[-1].split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="hiera_l")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--out_dir", default="exported")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()
    model = model_lib.build_sam2(args.variant, args.checkpoint, device=args.device)
    for name, path in export_all(model, args.out_dir).items():
        print(f"{name}: {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
