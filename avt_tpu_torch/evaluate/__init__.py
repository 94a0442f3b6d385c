"""Evaluation: the evaluator, its result sink and the offline metrics.

Counterpart of avt_tpu/evaluate (metrics, results, evaluator). The
per-process result files holding logits, targets, uids and unreduced losses
are the interface between training and offline metric computation; the
port writes them as numpy files (see `results`). The offline analysis
(EPIC metrics, late fusion, the challenge's submission files) is
`analysis`, imported on its own.
"""
from avt_tpu_torch.evaluate.evaluator import RESULTS_SAVE_DIR, evaluate
from avt_tpu_torch.evaluate.metrics import (
    combine_verb_noun_preds,
    compute_accuracy,
    compute_conf_mat,
    compute_topk,
    final_accuracies_from_results,
    mean_class_accuracy,
    softmax_np,
    topk_recall,
)
from avt_tpu_torch.evaluate.results import (
    STR_UID_MAXLEN,
    get_epoch_from_resdir,
    get_logits_from_results,
    read_all_results,
    read_results,
    store_append,
)

__all__ = [
    "RESULTS_SAVE_DIR", "STR_UID_MAXLEN", "combine_verb_noun_preds", "compute_accuracy",
    "compute_conf_mat", "compute_topk", "evaluate", "final_accuracies_from_results",
    "get_epoch_from_resdir", "get_logits_from_results", "mean_class_accuracy",
    "read_all_results", "read_results", "softmax_np", "store_append", "topk_recall",
]
