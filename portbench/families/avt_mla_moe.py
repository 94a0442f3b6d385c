"""How the benchmark drives AVT on its feature path with the Moonlight-16B-A3B
decoder as AVT-h's core (avt_tpu_torch/models/mla_moe.py): the model on the
benchmark's weights (one rank of expert parallelism: the configuration's
`n_routed_experts` of the router's `n_router_experts` held, those of
`expert_rank`), the train step as a user builds it, the launches it must
make and the program's side of the comparison. What it shares with the AVT
family (the train step, the batch, the readings) is families/avt.py's.

Everything of the program is imported inside the functions.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.families.avt import (  # noqa: F401  (the family interface)
    launch_counts,
    program_batch,
    reset_launch_counts,
    step_readings,
    train_program,
)
from portbench.reference import avt_mla_moe as reference
from portbench.work import mla_moe_flops

FLASH_MIN_TOKENS = 128  # ops/attention.py KERNEL_MIN_SEQ, on CUDA only
# the CPU events whose device time the readers take: the flash ops and the
# range the AVT family wraps around the optimizer
PROFILED_OPS = ("avt_tpu_torch::flash_attention", "avt_tpu_torch::flash_attention_bwd",
                "portbench.optimizer")
# the keys of the configuration file that the core takes, besides hidden_size
CORE_KEYS = ("num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "intermediate_size", "moe_intermediate_size",
             "n_router_experts", "expert_rank", "num_experts_per_tok", "n_shared_experts",
             "routed_scaling_factor", "first_k_dense_replace", "rope_theta", "rms_norm_eps")


def _dtype(name: str):
    return None if name == "float32" else getattr(torch, name)


def param_specs(cfg: dict):
    return reference.param_specs(cfg)


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """AVTModel as expts/02 composes it (identity backbone and aggregators,
    AVT-h returning the past too with its next-feature MSE, a linear
    classifier) with the MLA-MoE core, loaded with `weights`, in eval mode."""
    import functools

    from avt_tpu_torch.losses.mse import mse
    from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, LinearClassifier, MLAMoECore
    from avt_tpu_torch.models.backbones import IdentityBackbone

    m = cfg["model"]
    dtype, C, A = _dtype(m["compute_dtype"]), m["backbone_dim"], m["num_actions"]
    core = MLAMoECore(hidden_size=cfg["hidden_size"], experts_held=cfg["n_routed_experts"],
                      dtype=dtype, device=device, **{k: cfg[k] for k in CORE_KEYS})
    head = AVTh(in_features=C, inter_dim=cfg["hidden_size"], output_len=m["output_len"],
                avg_last_n=m["avg_last_n"], return_past_too=True,
                future_pred_loss=functools.partial(mse, reduction="none"), core=core,
                device=device)
    model = AVTModel(backbone=IdentityBackbone(), temporal_aggregator=IdentityAgg(in_features=C),
                     future_predictor=head,
                     temporal_aggregator_after_future_pred=IdentityAgg(in_features=C),
                     classifiers={"action": LinearClassifier(C, A, device=device)},
                     num_classes=(("action", A),), backbone_dim=C, dropout=m["dropout"],
                     classifier_on_past=m["classifier_on_past"])
    model.load_state_dict(weights, strict=True)
    return model.eval()


def clip_flops(cfg: dict, traffic: dict, mode: str) -> float:
    """Model FLOPs of one clip trained (work/mla_moe_flops.py)."""
    if mode != "train":
        raise ValueError("the MLA-MoE head is benchmarked in training only")
    return mla_moe_flops.train_clip_flops(cfg, traffic["length"])


def layers(cfg: dict) -> int:
    """Flash launches of each kind a step: one a decoder layer."""
    return cfg["num_hidden_layers"]


def mla_call(cfg: dict, traffic: dict, mode: str, clips: int):
    """(B, T, H, DQ, DV, dtype) of the flash launches (causal) a decoder
    layer makes over `clips` clips; None where the context is too short
    for the kernels."""
    T = traffic["length"]
    if T < FLASH_MIN_TOKENS:
        return None
    return (clips, T, cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"],
            cfg["model"]["compute_dtype"])


def expected_launches(cfg: dict, length: int, mode: str, device) -> Dict[str, int]:
    """The kernel launches of one train step: a flash forward and backward
    a decoder layer from 128 tokens on; nothing else of the port's own
    kernels (the core's linears are bf16, the classifiers' f32 nn.Linear)."""
    from avt_tpu_torch.ops import _build

    out = {k: 0 for k in _build.KERNELS}
    if torch.device(device).type == "cuda" and length >= FLASH_MIN_TOKENS:
        out["flash_attention_fwd"] = out["flash_attention_bwd"] = layers(cfg)
    return out


def counters() -> Dict[str, float]:
    """The port's counters since the last read (utils/trace.py), which
    resets them: the profiled units' when read after the profile pass."""
    from avt_tpu_torch.utils import trace

    return trace.counters()
