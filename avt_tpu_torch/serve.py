"""Serving: the eval forward as a callable or as a saved program, and the
batching host loop.

Counterpart of avt_tpu/serve.py (`make_eval_forward`, `export_eval_forward`,
`save_exported`, `load_exported`, `serving_fn`, `batch_predict`), with
`torch.export` in place of `jax.export`. An artifact is one static-shape
program: the device-side preprocessing (torch-exact resize, 1 or 3 crops and
their flips) with the multi-crop model forward, optionally with the trained
parameters inside it. The attention kernels are `torch.library` custom ops
(avt_tpu_torch/ops/flash_attention.py), so the program names them, and a
process that imports `avt_tpu_torch.ops` (and nothing of the models or the
config) loads and runs it.

Build artifacts with `tools/torch_export_model.py` (config + checkpoint ->
.pt2); load them with `load_exported(path)` and call `serving_fn(program)`
or `batch_predict(program, frames)`.

Under a profiler a `batch_predict` call is the span `avt.serve.request`,
with each batch's `avt.serve.download` of the outputs inside it, and the
eval forward's `model(video)` the span `avt.serve.forward`
(utils/trace.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from avt_tpu_torch.utils import trace
from avt_tpu_torch.utils.device import upload

DEFAULT_OUTPUTS = ("logits/action",)


def _eval_fn(model, preprocessor, outputs: Sequence[str]):
    """The eval forward as a plain function of the input."""
    device = next(model.parameters()).device

    def fwd(frames) -> Dict[str, torch.Tensor]:
        if preprocessor is not None:
            video = preprocessor.eval_fn(frames)[:, None]
        else:
            video = upload(frames, device)
        with trace.span("avt.serve.forward"):
            outs, _ = model(video)
        return {k: outs[k] for k in outputs}

    return fwd


def make_eval_forward(
    model,
    preprocessor=None,
    outputs: Sequence[str] = DEFAULT_OUTPUTS,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """frames_or_video -> dict of the requested endpoints, on the model's
    device, without autograd.

    With a preprocessor the input is raw (B, T, H, W, 3) uint8 frames (numpy
    or tensor) and the call runs preprocessing + forward, the bench.py
    main_eval topology; without, it is a preprocessed (B, #clips, [#crops,]
    C, T, H, W) video tensor."""
    return torch.inference_mode()(_eval_fn(model, preprocessor, outputs))


def model_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers by name, detached: the first
    input of a program exported with bake_params=False."""
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return {k: v.detach() for k, v in named.items()}


class _Baked(nn.Module):
    """frames -> outputs; the model is a submodule, so its parameters and
    buffers go into the program."""

    def __init__(self, model, preprocessor, outputs):
        super().__init__()
        self.model = model
        self.fwd = _eval_fn(model, preprocessor, outputs)

    def forward(self, frames):
        return self.fwd(frames)


class _Unbaked(nn.Module):
    """(params, frames) -> outputs, the model run on `params` through
    `torch.func.functional_call`. The model is held outside the module
    tree, so none of its tensors go into the program."""

    def __init__(self, model, preprocessor, outputs):
        super().__init__()
        self._held = (model, preprocessor, tuple(outputs))

    def forward(self, params, frames):
        model, preprocessor, outputs = self._held
        video = preprocessor.eval_fn(frames)[:, None] if preprocessor is not None else frames
        outs, _ = torch.func.functional_call(model, params, (video,))
        return {k: outs[k] for k in outputs}


def export_eval_forward(
    model,
    frame_shape: Tuple[int, ...],
    *,
    preprocessor=None,
    outputs: Sequence[str] = DEFAULT_OUTPUTS,
    platforms: Optional[Sequence[str]] = None,
    bake_params: bool = True,
    frame_dtype: Optional[torch.dtype] = None,
) -> torch.export.ExportedProgram:
    """The eval forward for `frame_shape` inputs as a `torch.export` program.

    frame_shape: the raw-frame shape (with a preprocessor; uint8 by
    default) or the video shape (without; float32 by default).
    bake_params=True keeps the model's parameters and buffers inside the
    program, whose one input is then the frames; False exports a program of
    (params, frames), params being `model_params(model)` or another
    checkpoint's tensors of the same names and shapes.

    platforms: the device the program is exported for, in place of JAX's
    list of lowering platforms: one entry, 'cuda' or 'cpu', which
    must be where the model and the preprocessor live (None: the model's
    device). A CUDA program runs the hand-written kernels, 12 packed
    attention launches a forward of the ViT-B flagship; a CPU program runs
    their plain versions. The program is traced in eval mode under
    torch.no_grad() (not inference_mode, whose tensors export refuses); the
    model's train/eval mode is restored afterwards."""
    device = next(model.parameters()).device
    if platforms is not None:
        wanted = [torch.device(p).type for p in platforms]
        if wanted != [device.type]:
            raise ValueError(f"platforms={tuple(platforms)}: a program is exported for one "
                             f"device, the model's ({device.type}); move the model first")
    if frame_dtype is None:
        frame_dtype = torch.uint8 if preprocessor is not None else torch.float32
    example = torch.zeros(tuple(frame_shape), dtype=frame_dtype, device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if bake_params:
                return torch.export.export(_Baked(model, preprocessor, outputs), (example,),
                                           strict=False)
            return torch.export.export(_Unbaked(model, preprocessor, outputs),
                                       (model_params(model), example), strict=False)
    finally:
        model.train(was_training)


def save_exported(program: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(program, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """The saved program; importing avt_tpu_torch.ops registers the custom
    ops it calls."""
    import avt_tpu_torch.ops  # noqa: F401  (registers the ops)

    return torch.export.load(path)


def _user_input_vals(program: torch.export.ExportedProgram):
    """The example values (fake tensors) of the program's user inputs."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"
            and n.name in names]


def _user_output_vals(program: torch.export.ExportedProgram):
    names = program.graph_signature.user_outputs
    out = next(n for n in program.graph.nodes if n.op == "output")
    by_name = {a.name: a.meta["val"] for a in out.args[0] if hasattr(a, "name")}
    return [by_name[name] for name in names]


def serving_fn(program: torch.export.ExportedProgram) -> Callable:
    """The program as a callable: numpy or tensor inputs (the frames, and
    for an unbaked program the params first) go to the program's device;
    runs without autograd. Building it unlifts the program into a module
    (about half a second for the flagship), so a server builds it once and
    keeps it; its `program` attribute is the program, which `batch_predict`
    reads."""
    module = program.module()
    device = _user_input_vals(program)[-1].device

    def to_device(x):
        return torch.as_tensor(x).to(device) if isinstance(x, (np.ndarray, torch.Tensor)) else x

    @torch.no_grad()
    def call(*args):
        return module(*pytree.tree_map(to_device, args))

    call.program = program
    return call


@trace.spanned("avt.serve.request")
def batch_predict(
    fwd: Union[Callable, torch.export.ExportedProgram],
    frames: np.ndarray,
    batch_size: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Splits frames on axis 0 into batches of `batch_size`, pads the tail
    batch with copies of its last clip so every call has one shape, trims
    the padding off the outputs, and concatenates them as numpy arrays. An
    empty input gives empty per-key outputs.

    fwd: a callable (`make_eval_forward`'s), which needs `batch_size`; or an
    exported program with its parameters baked in, or `serving_fn` of one
    (which a server keeps: a program is made a module anew each call),
    whose batch size is the program's input's: a `batch_size` that
    disagrees with it raises, and so does an unbaked program."""
    program = fwd if isinstance(fwd, torch.export.ExportedProgram) else getattr(
        fwd, "program", None)
    if program is not None:
        ins = _user_input_vals(program)
        if len(ins) != 1:
            raise ValueError("batch_predict needs a params-baked artifact (single input); "
                             f"this one takes {len(ins)} arrays")
        want_b = ins[0].shape[0]
        if batch_size is not None and batch_size != want_b:
            raise ValueError(f"artifact is compiled for batch {want_b}, got {batch_size}")
        batch_size = want_b
        if frames.shape[0] == 0:  # an empty shard: empty per-key outputs
            leaves = [torch.empty((0,) + tuple(v.shape[1:]), dtype=v.dtype).float().numpy()
                      for v in _user_output_vals(program)]
            return pytree.tree_unflatten(leaves, program.call_spec.out_spec)
        if fwd is program:
            fwd = serving_fn(program)
    elif batch_size is None:
        raise ValueError("batch_predict needs a batch_size for a callable")
    n = frames.shape[0]
    if n == 0:  # an empty shard runs the forward on zero clips: no work, right shapes
        return {k: v.float().cpu().numpy() for k, v in fwd(frames).items()}
    outs = []
    for i in range(0, n, batch_size):
        chunk = frames[i:i + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        res = fwd(chunk)
        with trace.span("avt.serve.download"):
            outs.append({k: v[: batch_size - pad].float().cpu().numpy() for k, v in res.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
