"""Offline analysis: marginalization, late fusion, challenge packaging.

Counterpart of avt_tpu/evaluate/analysis.py, on the port's result files
(`results.read_results` over the npz sink) and its annotation `Table` in
place of a DataFrame:
  * compute_accuracies_epic / epic100_unseen_tail_eval: the verb/noun/action
    metric bundle with the many-shot, tail and unseen-participant recall
    splits from the RULSTM id csvs (read with the csv module);
  * get_marginalized_scores: verb/noun scores from the action probabilities
    through the dataset's mapping matrices, unless the run stored verb and
    noun logits itself;
  * late_fuse: weighted score fusion across runs keyed by uid, with an
    optional p-norm normalization and external json or pkl scores;
  * package_results_for_submission[_ek100]: the EPIC challenge's jsons
    (the top-100 actions as 'verb,noun' keys, uniform scores for discarded
    uids, the sls codes) and submit.zip;
  * summarize_results and the figure helpers. matplotlib, seaborn and cv2
    are imported inside the functions that draw, so that the module
    imports without them.

Functions take result directories (or score dicts in memory) and dataset
objects, as the JAX package's do.
"""
from __future__ import annotations

import csv
import json
import logging
import os
import os.path as osp
import pickle as pkl
import zipfile
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from avt_tpu_torch.evaluate.metrics import combine_verb_noun_preds, compute_accuracy, softmax_np
from avt_tpu_torch.evaluate.results import get_logits_from_results, read_results

LOG = logging.getLogger(__name__)
TASK_COLUMNS = (("v", "verb", "verb_class"), ("n", "noun", "noun_class"),
                ("a", "action", "action_class"))


# ----------------------------------------------------------- epic metrics
def compute_accuracies_epic(probs: Sequence[np.ndarray], dataset) -> Dict:
    """The verb/noun/action metric bundle of an EPIC dataset.

    probs: [verb (N, Cv), noun (N, Cn), action (N, Ca)] scores aligned with
    the rows of dataset.df."""
    manyshot = dataset.classes_manyshot
    out = {}
    for (pfx, task, col), scores in zip(TASK_COLUMNS, probs):
        labels = dataset.df[col]
        top1, top5, rec5, top1_meancls, rec5_per_cls = compute_accuracy(scores, labels)
        rec5_ms = float("nan")
        if task in manyshot:
            _, _, rec5_ms, _, _ = compute_accuracy(scores, labels, manyshot[task])
        out.update({f"{pfx}top1": top1, f"{pfx}top5": top5, f"{pfx}rec5": rec5,
                    f"{pfx}rec5_ms": rec5_ms, f"{pfx}top1_meancls": top1_meancls,
                    f"{pfx}rec5_per_cls": rec5_per_cls})
    # the EK100 tail and unseen splits, when the RULSTM id csvs are there
    rulstm_dir = getattr(dataset, "rulstm_annotation_dir", None)
    if (rulstm_dir and getattr(dataset, "version", None) == 0.2
            and osp.exists(osp.join(rulstm_dir, "validation_unseen_participants_ids.csv"))
            and "narration_id" in dataset.df.columns):
        out.update(epic100_unseen_tail_eval(probs, dataset))
    return out


def read_id_csv(fpath) -> list:
    """The first column of a csv without a header, typed as pandas'
    read_csv types a column: ints when every value reads as one, else
    floats, else strings."""
    with open(fpath, "r", newline="") as fin:
        values = [row[0] for row in csv.reader(fin) if row]
    for conv in (int, float):
        try:
            return [conv(v) for v in values]
        except ValueError:
            continue
    return values


def epic100_unseen_tail_eval(probs: Sequence[np.ndarray], dataset) -> Dict:
    """Recall@5 on the EK100 tail-class and unseen-participant subsets."""
    rdir, df = dataset.rulstm_annotation_dir, dataset.df

    def _mask(name):
        return df.isin("narration_id", read_id_csv(osp.join(rdir, name)))

    unseen = _mask("validation_unseen_participants_ids.csv")
    tails = {"v": _mask("validation_tail_verbs_ids.csv"),
             "n": _mask("validation_tail_nouns_ids.csv"),
             "a": _mask("validation_tail_actions_ids.csv")}
    out = {}
    for (pfx, _, col), scores in zip(TASK_COLUMNS, probs):
        labels = df[col]
        _, _, tail, _, _ = compute_accuracy(scores[tails[pfx]], labels[tails[pfx]])
        _, _, uns, _, _ = compute_accuracy(scores[unseen], labels[unseen])
        out[f"{pfx}rec5_tail"] = tail
        out[f"{pfx}rec5_unseen"] = uns
    return out


def format_accuracies_epic(metrics: Dict, prefix: str = "") -> List[str]:
    """The reference's EPIC metric report lines."""
    m = metrics
    lines = [
        f"[{prefix}] Accuracies verb/noun/action: {m['vtop1']:.1f} {m['vtop5']:.1f} "
        f"{m['ntop1']:.1f} {m['ntop5']:.1f} {m['atop1']:.1f} {m['atop5']:.1f}",
        f"[{prefix}] Mean class top-1 accuracies verb/noun/action: "
        f"{m['vtop1_meancls']:.1f} {m['ntop1_meancls']:.1f} {m['atop1_meancls']:.1f}",
        f"[{prefix}] Recall@5 verb/noun/action: {m['vrec5']:.1f} {m['nrec5']:.1f} "
        f"{m['arec5']:.1f}",
        f"[{prefix}] Recall@5 many shot verb/noun/action: {m['vrec5_ms']:.1f} "
        f"{m['nrec5_ms']:.1f} {m['arec5_ms']:.1f}",
    ]
    if "vrec5_tail" in m:  # EK100: tail and unseen come together
        lines += [
            f"[{prefix}] Recall@5 tail verb/noun/action: {m['vrec5_tail']:.1f} "
            f"{m['nrec5_tail']:.1f} {m['arec5_tail']:.1f}",
            f"[{prefix}] Recall@5 unseen verb/noun/action: {m['vrec5_unseen']:.1f} "
            f"{m['nrec5_unseen']:.1f} {m['arec5_unseen']:.1f}",
        ]
    return lines


def print_accuracies_epic(metrics: Dict, prefix: str = "") -> None:
    for line in format_accuracies_epic(metrics, prefix):
        print(line)


def get_epic_action_accuracy(verb_resdir: str, verb_dataset, noun_resdir: str,
                             noun_dataset) -> Dict:
    """Action metrics implied by separate verb and noun runs: the outer
    product of the two runs' softmax scores scores the verb x noun grid.
    Returns the keys of compute_accuracies_epic (many-shot slots NaN)."""
    res_verb = get_logits_from_results(read_results(verb_resdir))
    res_noun = get_logits_from_results(read_results(noun_resdir))
    if isinstance(res_verb, dict) or isinstance(res_noun, dict):
        raise ValueError(
            "get_epic_action_accuracy needs single-task runs; got multiple logits keys "
            f"(verb: {sorted(res_verb) if isinstance(res_verb, dict) else 'ok'}, "
            f"noun: {sorted(res_noun) if isinstance(res_noun, dict) else 'ok'})")
    assert len(verb_dataset.df) == len(res_verb) == len(noun_dataset.df) == len(res_noun)
    out = {}
    for pfx, scores, ds, col in (("v", res_verb, verb_dataset, "verb_class"),
                                 ("n", res_noun, noun_dataset, "noun_class")):
        top1, top5, rec5, top1_meancls, rec5_per_cls = compute_accuracy(scores, ds.df[col])
        out.update({f"{pfx}top1": top1, f"{pfx}top5": top5, f"{pfx}rec5": rec5,
                    f"{pfx}rec5_ms": float("nan"), f"{pfx}top1_meancls": top1_meancls,
                    f"{pfx}rec5_per_cls": rec5_per_cls})
    res_action = combine_verb_noun_preds(res_verb, res_noun)
    # flat action ids stride by the noun vocabulary's size, which the
    # logits' columns must match
    cls = noun_dataset.classes
    num_noun = (len(cls["noun"]) if isinstance(cls, dict) and "noun" in cls
                else res_noun.shape[1])
    assert res_noun.shape[1] == num_noun, (
        f"noun logits have {res_noun.shape[1]} columns but the dataset has {num_noun} noun "
        "classes")
    true_action = verb_dataset.df["verb_class"] * num_noun + noun_dataset.df["noun_class"]
    atop1, atop5, arec5, atop1_meancls, arec5_per_cls = compute_accuracy(res_action,
                                                                         true_action)
    out.update({"atop1": atop1, "atop5": atop5, "arec5": arec5, "arec5_ms": float("nan"),
                "atop1_meancls": atop1_meancls, "arec5_per_cls": arec5_per_cls})
    for line in format_accuracies_epic(out):
        LOG.info("%s", line)
    return out


# -------------------------------------------------------- marginalization
def get_marginalized_scores(resdir: str, dataset):
    """A run's verb/noun/action scores, marginalized from the action
    scores when the run stored no verb and noun logits. Returns
    (accuracies, [verb, noun, action] arrays)."""
    results = read_results(resdir)
    if {"logits/verb", "logits/noun", "logits/action"} <= set(results):
        res_verb, res_noun = results["logits/verb"], results["logits/noun"]
        res_action = results["logits/action"]
    else:
        res_action = results["logits/action"]
        probs = softmax_np(res_action)
        cm = dataset.class_mappings
        res_verb = probs @ np.asarray(cm[("verb", "action")])
        res_noun = probs @ np.asarray(cm[("noun", "action")])
    scores = [res_verb, res_noun, res_action]
    return compute_accuracies_epic(scores, dataset), scores


def scores_with_uids(scores: Sequence[np.ndarray], dataset, uid_key="uid"):
    """[array, ...] -> [{uid: row}, ...] keyed by the dataset's uids."""
    uids = [str(el) for el in dataset.df[uid_key]]
    return [dict(zip(uids, space)) for space in scores]


# ------------------------------------------------------------ late fusion
def normalize_scores(scores, p):
    return [{uid: val / (np.linalg.norm(val, ord=p, axis=-1) + 1e-6)
             for uid, val in space.items()} for space in scores]


def load_external_json(fpath, verb_noun_to_action, nclasses):
    """An EPIC-format submission json -> [{uid: scores}, ...]."""
    with open(fpath, "r") as fin:
        preds = json.load(fin)
    all_res = []
    for j, space in enumerate(["verb", "noun", "action"]):
        res = {}
        for key, val in preds["results"].items():
            scores = np.zeros((nclasses[j],))
            for i, score in val[space].items():
                if space == "action":
                    idx = verb_noun_to_action[tuple(int(el) for el in i.split(","))]
                else:
                    idx = int(i)
                scores[idx] = score
            res[key] = scores
        all_res.append(res)
    return all_res


def load_external_pkl(fpath):
    with open(fpath, "rb") as fin:
        scores = pkl.load(fin)
    return [scores["verb_scores"], scores["noun_scores"], scores["action_scores"]]


def late_fuse(all_scores: Sequence[Sequence[Dict[str, np.ndarray]]],
              weights: Union[float, Sequence[float]] = 1.0, dataset=None, uid_key: str = "uid",
              normalize_before_combine: Optional[int] = None):
    """Weighted late fusion of per-uid scores across runs.

    all_scores: one [{uid: verb}, {uid: noun}, {uid: action}] triple a run.
    Returns (accuracies or None, the combined [{uid: scores}, ...])."""
    if isinstance(weights, float):
        weights = [weights] * len(all_scores)
    assert len(weights) == len(all_scores)
    if normalize_before_combine is not None:
        all_scores = [normalize_scores(s, normalize_before_combine) for s in all_scores]
    combined = []
    for space_id in range(3):
        per_run = [scores[space_id] for scores in all_scores]
        total_uids = set.union(*[set(el.keys()) for el in per_run])
        combined.append({
            uid: np.sum(np.stack([run[uid] * w for run, w in zip(per_run, weights)
                                  if uid in run]), axis=0)
            for uid in total_uids})
    accuracies = None
    if dataset is not None:
        combined_np = [np.asarray([space[str(uid)] for uid in dataset.df[uid_key]])
                       for space in combined]
        accuracies = compute_accuracies_epic(combined_np, dataset)
    return accuracies, combined


# --------------------------------------------------- challenge packaging
def struct_outputs(combined, dataset, uid_key="uid") -> Dict:
    """The EPIC submission dict: per-uid verb and noun scores and the
    top-100 actions; discarded uids get uniform scores."""
    results = {}
    action_to_verb_noun = {val: key for key, val in dataset.verb_noun_to_action.items()}
    for uid in combined[0].keys():
        verb_res = {f"{j}": float(v) for j, v in enumerate(combined[0][uid])}
        noun_res = {f"{j}": float(v) for j, v in enumerate(combined[1][uid])}
        act = combined[2][uid]
        topn = min(100, act.shape[-1])
        top100 = sorted(np.argpartition(act, -topn)[-topn:], key=lambda x: -act[x])
        action_res = {",".join(str(el) for el in action_to_verb_noun[j]): float(act[j])
                      for j in top100}
        results[f"{uid}"] = {"verb": verb_res, "noun": noun_res, "action": action_res}
    discarded = dataset.discarded_df
    if discarded is not None and len(discarded):
        for uid in discarded[uid_key]:
            if str(uid) in results:
                continue
            results[f"{uid}"] = {
                "verb": {f"{j}": 0.0 for j in range(len(dataset.verb_classes))},
                "noun": {f"{j}": 0.0 for j in range(len(dataset.noun_classes))},
                "action": {f"0,{j}": 0.0 for j in range(100)},
            }
    return {"version": f"{dataset.version}", "challenge": dataset.challenge_type,
            "results": results}


def _write_zip(output_dir: str, fnames: Sequence[str]):
    with zipfile.ZipFile(osp.join(output_dir, "submit.zip"), "w") as zf:
        for fname in fnames:
            zf.write(osp.join(output_dir, fname), arcname=fname)


def package_results_for_submission(seen_combined, seen_dataset, unseen_combined,
                                   unseen_dataset, output_dir):
    """EK55 challenge: seen.json + unseen.json + submit.zip."""
    os.makedirs(output_dir, exist_ok=True)
    for name, combined, ds in (("seen.json", seen_combined, seen_dataset),
                               ("unseen.json", unseen_combined, unseen_dataset)):
        with open(osp.join(output_dir, name), "w") as fout:
            json.dump(struct_outputs(combined, ds), fout, indent=4)
    _write_zip(output_dir, ["seen.json", "unseen.json"])


def package_results_for_submission_ek100(combined, dataset, output_dir, sls=(1, 4, 4),
                                         uid_key="narration_id"):
    """EK100 challenge: test.json with the sls codes + submit.zip."""
    os.makedirs(output_dir, exist_ok=True)
    res = struct_outputs(combined, dataset, uid_key=uid_key)
    res["sls_pt"], res["sls_tl"], res["sls_td"] = sls
    with open(osp.join(output_dir, "test.json"), "w") as fout:
        json.dump(res, fout, indent=4)
    _write_zip(output_dir, ["test.json"])


# ----------------------------------------------------------- summarizer
def summarize_results(expt_file: str, output_root: str = "OUTPUTS", metric: str = "arec5",
                      dataset_fn=None):
    """Mean and std of a metric across the sweep run_ids of an experiment.

    dataset_fn(run_id) builds the eval dataset for the marginalization.
    Runs with no or empty results (unfinished trainings) are skipped."""
    from avt_tpu_torch.config.overrides import expand_sweeps, parse_overrides_file

    variants = expand_sweeps(parse_overrides_file(expt_file))
    expt = osp.splitext(osp.basename(expt_file))[0]
    by_params: Dict = {}
    for run_id, variant in enumerate(variants):
        resdir = osp.join(output_root, expt, str(run_id), "results")
        try:
            dataset = dataset_fn(run_id)
            accuracies, _ = get_marginalized_scores(resdir, dataset)
        except (FileNotFoundError, ValueError, KeyError) as err:
            LOG.warning("Skipping run %d: %s", run_id, err)
            continue
        params = tuple(sorted(f"{o.key}={o.value}" for o in variant if o.key != "run_id"))
        by_params.setdefault(params, {})[run_id] = accuracies[metric]
    summary = {}
    for params, runs in by_params.items():
        vals = list(runs.values())
        summary[params] = {"runs": sorted(runs), "values": vals, "mean": float(np.mean(vals)),
                           "std": float(np.std(vals))}
    return summary


# ------------------------------------------------------ per-class plots
def save_graph(fig, outfpath: str, root_dir: str = "./", **kwargs):
    """Despine (top and right), then save tight and transparent, making the
    target's directory."""
    try:
        import seaborn as sns

        sns.despine(fig=fig, top=True, right=True, left=False, bottom=False)
    except ImportError:  # the same despine by hand
        for ax in fig.axes:
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
    final = osp.join(root_dir, outfpath)
    os.makedirs(osp.dirname(final) or ".", exist_ok=True)
    fig.savefig(final, bbox_inches="tight", transparent=True, pad_inches=0, **kwargs)
    return final


def overlay_text(frames: np.ndarray, texts: Sequence[str]) -> np.ndarray:
    """Burn the GT and Pred labels into (T, H, W, 3) uint8 frames: a white
    banner when the prediction matches the ground truth, pink when it does
    not (the glyphs through cv2 when it is there, else the banner alone).
    Returns a new array."""
    assert len(texts) == 2, "pass [gt, pred]"
    color = (255, 255, 255) if texts[0] == texts[1] else (255, 192, 203)
    labels = [f"GT: {texts[0]}", f"Pred: {texts[1]}"]
    out = np.array(frames, copy=True)
    banner_h = max(14, out.shape[1] // 8)
    out[:, : 2 * banner_h, -out.shape[2] // 2:] = color
    try:
        import cv2

        scale = banner_h / 32.0
        for t in range(out.shape[0]):
            for li, label in enumerate(labels):
                cv2.putText(out[t], label,
                            (out.shape[2] - out.shape[2] // 2 + 2, int((li + 0.8) * banner_h)),
                            cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 1, cv2.LINE_AA)
    except ImportError:
        LOG.warning("cv2 unavailable: overlay banner drawn without text glyphs")
    return out


def plot_per_cls_perf(per_cls_accs: Sequence[Sequence[Dict[int, float]]], names: Sequence[str],
                      *, cls_id_to_name: Optional[Dict[int, str]] = None, show_topn: int = 10,
                      show_subset=None, xticks_rotation: float = 0.0,
                      ylabel: str = "Recall @ 5", outfpath: Optional[str] = None):
    """Bar chart of the per-class accuracy of the classes the LAST method
    improves most over the FIRST.

    per_cls_accs: one list a method, of per-run {cls_id: accuracy} dicts
    (e.g. compute_accuracies_epic's 'vrec5_per_cls' of each run_id of a
    sweep). Returns (figure, the gained class names); saves the figure when
    outfpath is set."""
    assert len(per_cls_accs) == len(names)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cls_id_to_name = cls_id_to_name or {}
    # accs[method][cls_name]: that class's accuracy in each run, in run order
    accs: Dict[str, Dict[str, List[float]]] = {}
    for name, runs in zip(names, per_cls_accs):
        per_cls = accs.setdefault(name, {})
        for run in runs:
            for cls_id, score in run.items():
                per_cls.setdefault(cls_id_to_name.get(cls_id, str(cls_id)), []).append(
                    float(score))
    first, last = accs.get(names[0], {}), accs.get(names[-1], {})
    # the classes measured under both methods, in sorted order (the key
    # order of an outer merge); a class measured under only one has no gain
    both = sorted(set(first) & set(last))
    gains = np.asarray([np.mean(last[c]) - np.mean(first[c]) for c in both])
    gained = [both[i] for i in gains.argsort(kind="quicksort")]
    if show_subset is not None:
        gained = [el for el in gained if show_subset(el)]
    gained = gained[-show_topn:]

    fig, ax = plt.subplots(figsize=(max(2 * len(gained), 4), 4), dpi=150)
    width = 0.8 / max(len(names), 1)
    xs = np.arange(len(gained))
    for mi, name in enumerate(names):
        per_cls = accs.get(name, {})
        means = [np.mean(per_cls[c]) if c in per_cls else np.nan for c in gained]
        stds = [np.std(per_cls[c]) if c in per_cls else np.nan for c in gained]
        ax.bar(xs + (mi - (len(names) - 1) / 2) * width, means, width,
               yerr=np.nan_to_num(stds), label=name, capsize=2)
    ax.set_xticks(xs)
    ax.set_xticklabels(gained, rotation=xticks_rotation, ha="center")
    ax.set_xlabel("Classes")
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.tight_layout()
    if outfpath:
        os.makedirs(osp.dirname(outfpath) or ".", exist_ok=True)
        fig.savefig(outfpath)
    return fig, gained
