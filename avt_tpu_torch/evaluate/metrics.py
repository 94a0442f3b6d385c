"""Offline metrics: top-k, class-mean recall@5, mean-class accuracy.

Counterpart of avt_tpu/evaluate/metrics.py, a numpy copy (the port keeps
its own): `compute_topk`, `topk_recall` (RULSTM's class-mean recall@k, the
EK100 anticipation headline), `compute_conf_mat`, `mean_class_accuracy`,
`compute_accuracy` (with its confusion-matrix cross-check of top-1),
`softmax_np`, `combine_verb_noun_preds` and `final_accuracies_from_results`
(the 'final_acc/<task>/{top1,top5,AR5,top1_meanOverClasses,AR5_manyshot}'
dictionary).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np


def compute_topk(
    predictions: np.ndarray,
    labels: np.ndarray,
    k: int,
    classes: Optional[Sequence[int]] = None,
) -> float:
    """Top-k accuracy (%) restricted to samples of the given classes."""
    if classes is None:
        classes = np.unique(labels)
    keep = np.isin(labels, list(classes))
    predictions = predictions[keep]
    labels = labels[keep]
    k = min(k, predictions.shape[-1])  # tiny vocabularies: top-k == all
    top_predictions = np.argpartition(predictions, -k, axis=-1)[:, -k:]
    ratio_solved = np.mean(
        np.any(labels[:, np.newaxis] == top_predictions, axis=-1)
    )
    return float(ratio_solved * 100.0)


def topk_recall(
    scores: np.ndarray,
    labels: np.ndarray,
    k: int = 5,
    classes: Optional[Sequence[int]] = None,
    return_per_class: bool = False,
):
    """Class-mean recall@k in [0, 1] (RULSTM convention).

    Mean over classes that occur in `labels` (intersected with `classes`
    if given) of the per-class fraction whose label lands in the top-k.
    return_per_class additionally returns {cls_id: recall} (the RULSTM
    topk_recall per-class mode the reference's notebooks consume).
    Raises ZeroDivisionError when no requested class occurs — the caller
    maps that to NaN, like the reference.
    """
    unique = np.unique(labels)
    if classes is None:
        cls_list = unique
    else:
        cls_list = np.intersect1d(np.asarray(list(classes)), unique)
    k = min(k, scores.shape[-1])
    top_k = np.argpartition(scores, -k, axis=-1)[:, -k:]
    hit = np.any(labels[:, None] == top_k, axis=-1)
    per_class = {}
    recalls = 0.0
    for c in cls_list:
        sel = labels == c
        r = float(np.mean(hit[sel]))
        per_class[int(c)] = r
        recalls += r
    mean = recalls / len(cls_list)  # ZeroDivisionError if empty, on purpose
    if return_per_class:
        return mean, per_class
    return mean


def compute_conf_mat(predictions: np.ndarray, target: np.ndarray) -> np.ndarray:
    """(C, C) confusion matrix; rows = true class, cols = argmax pred.

    Negative targets (unlabeled test points) contribute nothing.
    """
    num_classes = predictions.shape[1]
    conf = np.zeros((num_classes, num_classes), dtype=np.float64)
    pred_idx = np.argmax(predictions, axis=1)
    valid = target >= 0
    np.add.at(conf, (target[valid], pred_idx[valid]), 1.0)
    return conf


def mean_class_accuracy(conf_mat: np.ndarray) -> float:
    cls_cnt = conf_mat.sum(axis=1) + 1e-15
    cls_hit = np.diag(conf_mat)
    return float(np.mean(cls_hit / cls_cnt))


def compute_accuracy(
    predictions: np.ndarray,
    labels: np.ndarray,
    classes: Optional[Mapping[str, int]] = None,
) -> Tuple[float, float, float, float, Dict]:
    """(top1, top5, AR5 (%), top1_meancls, per-class AR5 dict).

    classes: optional {name: cls_id} subset (e.g. many-shot classes).
    """
    if predictions.size == 0:
        return [float("nan")] * 5
    labels = labels.astype(np.int64)
    if classes is not None:
        classes_to_keep = list(classes.values())
    else:
        classes_to_keep = list(range(max(labels) + 1))
    top_1 = compute_topk(predictions, labels, 1, classes=classes_to_keep)
    top_5 = compute_topk(predictions, labels, 5, classes=classes_to_keep)
    try:
        ar5, per_cls = topk_recall(
            predictions, labels, k=5, classes=classes_to_keep,
            return_per_class=True,
        )
        # reference scales per-class values to % (notebooks/utils.py:344)
        ar5_per_cls = {c: v * 100.0 for c, v in per_cls.items()}
    except ZeroDivisionError:
        ar5 = float("nan")
        ar5_per_cls = {c: float("nan") for c in classes_to_keep}
    conf_mat = compute_conf_mat(predictions, labels)
    # top-1 computed a second way as a cross-check (reference :355-374)
    kept = np.asarray(classes_to_keep)
    denom = conf_mat[kept].sum()
    if denom > 0:
        top_1_confmat = 100.0 * (np.diag(conf_mat)[kept].sum() / denom)
        if not np.isnan(top_1) and not np.isclose(top_1, top_1_confmat, atol=1.0):
            raise ValueError(
                f"top1 ({top_1}) != conf-mat top1 ({top_1_confmat}); "
                "argmax ambiguity or a metric bug"
            )
    top1_meancls = 100.0 * mean_class_accuracy(conf_mat)
    return top_1, top_5, ar5 * 100.0, top1_meancls, ar5_per_cls


def softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)


def combine_verb_noun_preds(res_verb: np.ndarray, res_noun: np.ndarray) -> np.ndarray:
    """Outer-product verb/noun softmax scores -> (N, C_verb*C_noun)."""
    num_elts = res_verb.shape[0]
    res_verb = softmax_np(res_verb)
    res_noun = softmax_np(res_noun)
    return np.einsum("ij,ik->ijk", res_verb, res_noun).reshape((num_elts, -1))


def final_accuracies_from_results(
    results: Dict[str, np.ndarray],
    classes_manyshot: Optional[Mapping[str, Mapping[str, int]]] = None,
) -> Dict[str, float]:
    """'final_acc/<task>/*' metrics from a read_results dict."""
    accs: Dict[str, float] = {}
    for key in results:
        if not key.startswith("logits/"):
            continue
        task = key[len("logits/"):]
        target = results[f"target/{task}"]
        top1, top5, ar5, top1_meancls, _ = compute_accuracy(results[key], target)
        accs[f"final_acc/{task}/top1"] = top1
        accs[f"final_acc/{task}/top1_meanOverClasses"] = top1_meancls
        accs[f"final_acc/{task}/top5"] = top5
        accs[f"final_acc/{task}/AR5"] = ar5
        if classes_manyshot and task in classes_manyshot:
            _, _, ar5_ms, _, _ = compute_accuracy(
                results[key], target, classes_manyshot[task]
            )
            accs[f"final_acc/{task}/AR5_manyshot"] = ar5_ms
    return accs
