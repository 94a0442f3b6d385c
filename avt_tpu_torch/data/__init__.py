"""Host data layer and device preprocessing.

Counterpart of avt_tpu/data: the annotation tables (`table.Table` in place
of pandas), the anticipation window math, the clip and frame sampling, the
feature readers, `VideoDataset` and `EpicKitchens`, the clip samplers, the
threaded `DataLoader`, and the preprocessing of raw frames on the device
(`transforms`).
"""
from avt_tpu_torch.data.anticipation import (
    FUTURE_PREFIX,
    RULSTM_TSN_FPS,
    convert_to_anticipation,
    dense_clip_sampler,
    dense_labels_to_segments,
)
from avt_tpu_torch.data.dataset import ConcatDataset, VideoDataset
from avt_tpu_torch.data.epic_kitchens import EpicKitchens
from avt_tpu_torch.data.loader import DataLoader, collate
from avt_tpu_torch.data.readers import (
    LMDBFeatsReader,
    NpyFeatsReader,
    Reader,
    VideoAsLabelOnehotReader,
)
from avt_tpu_torch.data.table import Table

__all__ = [
    "ConcatDataset", "DataLoader", "EpicKitchens", "FUTURE_PREFIX", "LMDBFeatsReader",
    "NpyFeatsReader", "RULSTM_TSN_FPS", "Reader", "Table", "VideoAsLabelOnehotReader",
    "VideoDataset", "collate", "convert_to_anticipation", "dense_clip_sampler",
    "dense_labels_to_segments",
]
