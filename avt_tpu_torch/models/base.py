"""AVTModel: the composition root.

Counterpart of avt_tpu/models/base.py, keeping its endpoint dict:
  backbone, backbone_mean, backbone_mean_projected, temp_agg,
  temp_agg_projected, past, future, future_projected, future_agg,
  logits/<task>, past_logits/<task>, logits_regression
Pipeline: backbone -> spatial mean -> optional mapper to an intermediate
width -> temporal aggregator -> optional reset of its width -> unfold clips
into time -> future predictor -> (past classifier) -> second aggregator ->
dropout -> per-task classifiers, or class-mapping marginalisation from the
first classified task -> optional regression head.

Kept from the reference on purpose: 'future_projected' projects the
aggregated PAST feature (base_model.py:209).

Multi-crop input (a #crops dim) runs as ONE forward with the crops stacked
crop-major on the batch dim, and the outputs are averaged per crop after.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from avt_tpu_torch.models.layers import dropout

PAST_LOGITS_PREFIX = "past_"


class AVTModel(nn.Module):
    """backbone, aggregators, future predictor and classifiers are modules;
    `classifiers` maps task -> module, `num_classes` is a tuple of
    (task, n_classes) pairs, `class_mappings` a tuple of ((task, src_task),
    0/1 matrix (n_src, n_task)) pairs: a task without a classifier takes
    `logits/<src> @ matrix` from the first classified task. The backbone's
    parameters sit under `backbone.model.`, as the reference's frame-level
    wrapper keeps them. The optional parts, with the reference's names:
    `mapper_to_inter` (backbone_dim -> intermediate_featdim, no bias),
    `reset_temp_agg_feat_dim` (the aggregator's width back to the
    intermediate one, with same_temp_agg_dim), `project_mlp.{0,2}` (the NCE
    projection, project_dim_for_nce wide) and `regression_head` (one
    output)."""

    def __init__(self, backbone: nn.Module, temporal_aggregator: nn.Module,
                 future_predictor: nn.Module,
                 temporal_aggregator_after_future_pred: nn.Module,
                 classifiers: Mapping[str, nn.Module], num_classes, class_mappings=(),
                 backbone_dim: int = 2048, intermediate_featdim: Optional[int] = None,
                 temp_agg_output_dim: Optional[int] = None, same_temp_agg_dim: bool = False,
                 project_dim_for_nce: Optional[int] = None, dropout: float = 0.0,
                 classifier_on_past: bool = False, cls_input_dim: Optional[int] = None,
                 add_regression_head: bool = False, device=None):
        super().__init__()
        self.backbone = nn.ModuleDict({"model": backbone})
        self.temporal_aggregator = temporal_aggregator
        self.future_predictor = future_predictor
        self.temporal_aggregator_after_future_pred = temporal_aggregator_after_future_pred
        self.classifiers = nn.ModuleDict(dict(classifiers))
        self.num_classes = tuple(num_classes)
        self.backbone_dim = backbone_dim
        self.inter_dim = intermediate_featdim or backbone_dim
        self.classifier_on_past = classifier_on_past
        self.dropout = dropout
        if backbone_dim != self.inter_dim:
            self.mapper_to_inter = nn.Linear(backbone_dim, self.inter_dim, bias=False,
                                             device=device)
        agg_dim = temp_agg_output_dim or self.inter_dim
        self.reset_agg = same_temp_agg_dim and agg_dim != self.inter_dim
        if self.reset_agg:
            self.reset_temp_agg_feat_dim = nn.Linear(agg_dim, self.inter_dim, device=device)
            agg_dim = self.inter_dim
        self.agg_out_dim = agg_dim
        self.project_dim_for_nce = project_dim_for_nce
        if project_dim_for_nce is not None:
            self.project_mlp = nn.Sequential(
                nn.Linear(agg_dim, agg_dim, device=device), nn.ReLU(),
                nn.Linear(agg_dim, project_dim_for_nce, device=device))
        self.add_regression_head = add_regression_head
        if add_regression_head:
            if cls_input_dim is None:
                raise ValueError("add_regression_head needs cls_input_dim, the classifiers' "
                                 "input width")
            self.regression_head = nn.Linear(cls_input_dim, 1, device=device)
        # the mappings as non-persistent buffers: they move with the model and
        # stay out of its state_dict, as they are not parameters
        self.cls_maps = {}
        for (task, src), m in class_mappings:
            name = f"cls_map_{task}_{src}"
            self.register_buffer(name, torch.as_tensor(m, dtype=torch.float32, device=device),
                                 persistent=False)
            self.cls_maps[(task, src)] = name
        first = next(iter(self.classifiers), None)
        missing = [task for task, _ in self.num_classes if task not in self.classifiers
                   and (task, first) not in self.cls_maps]
        if missing:
            raise ValueError(f"tasks {missing} have neither a classifier nor a class mapping "
                             f"from {first!r}")

    def _project(self, x):
        return x if self.project_dim_for_nce is None else self.project_mlp(x)

    def _apply_classifier(self, feat, prefix: str = "") -> Dict[str, torch.Tensor]:
        outputs: Dict[str, torch.Tensor] = {}
        src = next(iter(self.classifiers))
        for task, _ in self.num_classes:
            if task in self.classifiers:
                outputs[f"{prefix}logits/{task}"] = self.classifiers[task](feat)
            else:  # marginalised from the first classified task (base_model.py:222-238)
                mapper = getattr(self, self.cls_maps[(task, src)])
                outputs[f"{prefix}logits/{task}"] = outputs[f"{prefix}logits/{src}"] @ mapper
        return outputs

    def _dropout(self, x, generator):
        return dropout(x, self.dropout, generator, self.training)

    def forward_singlecrop(self, video, target_shape=None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """video: (B, #clips, C, T, H, W)."""
        outputs: Dict[str, torch.Tensor] = {}
        aux_losses: Dict[str, torch.Tensor] = {}
        B, num_clips = video.shape[:2]
        video = video.reshape((B * num_clips,) + tuple(video.shape[2:]))
        feats = self.backbone["model"](video, generator)  # (B', C', T', H', W')
        outputs["backbone"] = feats
        feats = feats.mean(dim=(-1, -2))  # (B', C', T')
        outputs["backbone_mean"] = feats.mean(dim=-1)
        if (self.project_dim_for_nce is not None
                and outputs["backbone_mean"].shape[-1] == self.agg_out_dim):
            outputs["backbone_mean_projected"] = self._project(outputs["backbone_mean"])
        feats = feats.transpose(1, 2)  # (B', T', C')
        if feats.shape[-1] != self.inter_dim:
            if self.backbone_dim == self.inter_dim:
                raise ValueError(
                    f"Backbone produced {feats.shape[-1]}-d features but "
                    f"backbone_dim={self.backbone_dim}; set backbone_dim to the real "
                    "feature dim")
            feats = self.mapper_to_inter(feats)
        feats_agg, agg_losses = self.temporal_aggregator(feats, generator)
        aux_losses.update(agg_losses)
        if self.reset_agg:
            feats_agg = self.reset_temp_agg_feat_dim(feats_agg)
        outputs["temp_agg"] = feats_agg
        outputs["temp_agg_projected"] = self._project(feats_agg)
        if num_clips > 1:  # unfold the clips dim back out into time
            assert feats_agg.dim() == 2 or (feats_agg.dim() == 3 and feats_agg.shape[1] == 1), \
                "Use temporal aggregation when using subclips"
            feats_agg = feats_agg.reshape((B, num_clips) + tuple(feats_agg.shape[1:]))
            if feats_agg.dim() == 4:
                feats_agg = feats_agg.reshape(
                    (B, num_clips * feats_agg.shape[2]) + tuple(feats_agg.shape[3:]))
        feats_past, feats_future, fut_losses, endpoints = self.future_predictor(
            feats_agg, target_shape, generator=generator)
        aux_losses.update(fut_losses)
        outputs.update(endpoints)
        outputs["future"] = feats_future
        outputs["past"] = feats_past
        if self.classifier_on_past:
            outputs.update(self._apply_classifier(self._dropout(feats_past, generator),
                                                  PAST_LOGITS_PREFIX))
        outputs["future_projected"] = self._project(feats_agg)  # reference quirk: the PAST
        feats_future_agg, fagg_losses = self.temporal_aggregator_after_future_pred(
            feats_future, generator)
        aux_losses.update(fagg_losses)
        outputs["future_agg"] = feats_future_agg
        feats_drop = self._dropout(feats_future_agg, generator)
        outputs.update(self._apply_classifier(feats_drop))
        if self.add_regression_head:
            outputs["logits_regression"] = self.regression_head(feats_drop)
        return outputs, aux_losses

    def forward(self, video, target_shape: Optional[tuple] = None,
                generator: Optional[torch.Generator] = None):
        """video: (B, #clips, C, T, H, W) or (B, #clips, #crops, C, T, H, W).
        `generator` draws the train-mode dropout masks."""
        if video.dim() == 6:
            return self.forward_singlecrop(video, target_shape, generator)
        if video.dim() == 7 and video.shape[2] == 1:
            return self.forward_singlecrop(video[:, :, 0], target_shape, generator)
        if video.dim() != 7:
            raise NotImplementedError(f"Unsupported video shape {tuple(video.shape)}")
        B, num_clips, n = video.shape[:3]
        stacked = torch.cat([video[:, :, i] for i in range(n)], dim=0)  # crop-major
        outputs, losses = self.forward_singlecrop(stacked, target_shape, generator)
        # leading dims that carry the crop factor: n*B, or n*B*num_clips
        # before the clips are unfolded (e.g. 'backbone')
        crop_leading = (n * B, n * B * num_clips)

        def avg(v):
            if v.dim() >= 1 and v.shape[0] in crop_leading:
                return v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])).mean(dim=0)
            return v

        return ({k: avg(v) for k, v in outputs.items()},
                {k: avg(v) for k, v in losses.items()})
