"""AVTModel: the composition root.

Counterpart of avt_tpu/models/base.py, keeping its endpoint dict:
  backbone, backbone_mean, temp_agg, temp_agg_projected, past, future,
  future_projected, future_agg, logits/<task>, past_logits/<task>
Pipeline: backbone -> spatial mean -> temporal aggregator -> unfold clips
into time -> future predictor -> (past classifier) -> second aggregator ->
dropout -> per-task classifiers.

Kept from the reference on purpose: 'future_projected' is the aggregated
PAST feature (base_model.py:209). The mapper to an intermediate width, the
NCE projection, class-mapping marginalisation and the regression head are
not built by the flagship and are not ported yet.

Multi-crop input (a #crops dim) runs as ONE forward with the crops stacked
crop-major on the batch dim, and the outputs are averaged per crop after.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

PAST_LOGITS_PREFIX = "past_"


class AVTModel(nn.Module):
    """backbone, aggregators, future predictor and classifiers are modules;
    `classifiers` maps task -> module, `num_classes` is a tuple of
    (task, n_classes) pairs. The backbone's parameters sit under
    `backbone.model.`, as the reference's frame-level wrapper keeps them."""

    def __init__(self, backbone: nn.Module, temporal_aggregator: nn.Module,
                 future_predictor: nn.Module,
                 temporal_aggregator_after_future_pred: nn.Module,
                 classifiers: Mapping[str, nn.Module], num_classes,
                 backbone_dim: int = 2048, dropout: float = 0.0,
                 classifier_on_past: bool = False):
        super().__init__()
        self.backbone = nn.ModuleDict({"model": backbone})
        self.temporal_aggregator = temporal_aggregator
        self.future_predictor = future_predictor
        self.temporal_aggregator_after_future_pred = temporal_aggregator_after_future_pred
        self.classifiers = nn.ModuleDict(dict(classifiers))
        self.num_classes = tuple(num_classes)
        self.backbone_dim = backbone_dim
        self.classifier_on_past = classifier_on_past
        self.dropout = nn.Dropout(dropout)
        missing = [task for task, _ in self.num_classes if task not in self.classifiers]
        if missing:
            raise NotImplementedError(
                f"tasks {missing} have no classifier; class-mapping marginalisation "
                "is not ported yet")

    def _apply_classifier(self, feat, prefix: str = "") -> Dict[str, torch.Tensor]:
        return {f"{prefix}logits/{task}": self.classifiers[task](feat)
                for task, _ in self.num_classes}

    def forward_singlecrop(self, video, target_shape=None
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """video: (B, #clips, C, T, H, W)."""
        outputs: Dict[str, torch.Tensor] = {}
        aux_losses: Dict[str, torch.Tensor] = {}
        B, num_clips = video.shape[:2]
        video = video.reshape((B * num_clips,) + tuple(video.shape[2:]))
        feats = self.backbone["model"](video)  # (B', C', T', H', W')
        outputs["backbone"] = feats
        feats = feats.mean(dim=(-1, -2))  # (B', C', T')
        outputs["backbone_mean"] = feats.mean(dim=-1)
        feats = feats.transpose(1, 2)  # (B', T', C')
        if feats.shape[-1] != self.backbone_dim:
            raise ValueError(
                f"Backbone produced {feats.shape[-1]}-d features but "
                f"backbone_dim={self.backbone_dim}; set backbone_dim to the real "
                "feature dim")
        feats_agg, agg_losses = self.temporal_aggregator(feats)
        aux_losses.update(agg_losses)
        outputs["temp_agg"] = feats_agg
        outputs["temp_agg_projected"] = feats_agg
        if num_clips > 1:  # unfold the clips dim back out into time
            assert feats_agg.dim() == 2 or (feats_agg.dim() == 3 and feats_agg.shape[1] == 1), \
                "Use temporal aggregation when using subclips"
            feats_agg = feats_agg.reshape((B, num_clips) + tuple(feats_agg.shape[1:]))
            if feats_agg.dim() == 4:
                feats_agg = feats_agg.reshape(
                    (B, num_clips * feats_agg.shape[2]) + tuple(feats_agg.shape[3:]))
        feats_past, feats_future, fut_losses, endpoints = self.future_predictor(
            feats_agg, target_shape)
        aux_losses.update(fut_losses)
        outputs.update(endpoints)
        outputs["future"] = feats_future
        outputs["past"] = feats_past
        if self.classifier_on_past:
            outputs.update(self._apply_classifier(self.dropout(feats_past), PAST_LOGITS_PREFIX))
        outputs["future_projected"] = feats_agg  # reference quirk: the PAST
        feats_future_agg, fagg_losses = self.temporal_aggregator_after_future_pred(feats_future)
        aux_losses.update(fagg_losses)
        outputs["future_agg"] = feats_future_agg
        outputs.update(self._apply_classifier(self.dropout(feats_future_agg)))
        return outputs, aux_losses

    def forward(self, video, target_shape: Optional[tuple] = None):
        """video: (B, #clips, C, T, H, W) or (B, #clips, #crops, C, T, H, W)."""
        if video.dim() == 6:
            return self.forward_singlecrop(video, target_shape)
        if video.dim() == 7 and video.shape[2] == 1:
            return self.forward_singlecrop(video[:, :, 0], target_shape)
        if video.dim() != 7:
            raise NotImplementedError(f"Unsupported video shape {tuple(video.shape)}")
        B, num_clips, n = video.shape[:3]
        stacked = torch.cat([video[:, :, i] for i in range(n)], dim=0)  # crop-major
        outputs, losses = self.forward_singlecrop(stacked, target_shape)
        # leading dims that carry the crop factor: n*B, or n*B*num_clips
        # before the clips are unfolded (e.g. 'backbone')
        crop_leading = (n * B, n * B * num_clips)

        def avg(v):
            if v.dim() >= 1 and v.shape[0] in crop_leading:
                return v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])).mean(dim=0)
            return v

        return ({k: avg(v) for k, v in outputs.items()},
                {k: avg(v) for k, v in losses.items()})
