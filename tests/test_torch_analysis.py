"""avt_tpu_torch/evaluate/analysis.py and the results readers against
avt_tpu's, on one tiny EK100 tree that both packages' EpicKitchens read
(RULSTM csv annotations, the many-shot, tail and unseen id csvs, two early
actions that the anticipation shift discards), with the same seeded scores:
  * compute_accuracies_epic and epic100_unseen_tail_eval, key by key at
    1e-12, and their report lines;
  * get_marginalized_scores at 1e-6: avt_tpu reads its H5 files written by
    store_append_h5, the port its npz files written by store_append, of the
    same arrays;
  * late_fuse with weights, a p-norm and external json and pkl scores;
  * struct_outputs and the submission zips: the same names, the jsons
    equal once parsed;
  * summarize_results over a sweep with an unfinished run, the same lines;
  * get_logits_from_results, get_epoch_from_resdir, read_all_results,
    get_epic_action_accuracy, plot_per_cls_perf, save_graph, overlay_text.
"""
import json
import logging
import os
import pickle
import zipfile

import numpy as np
import pytest

from avt_tpu.data import NpyFeatsReader as JNpyFeatsReader
from avt_tpu.data import convert_to_anticipation as jconvert
from avt_tpu.data.epic_kitchens import EPIC100_VERSION
from avt_tpu.data.epic_kitchens import EpicKitchens as JEpicKitchens
from avt_tpu.evaluate import analysis as ja
from avt_tpu.evaluate import results as jres
from avt_tpu_torch.data import NpyFeatsReader, convert_to_anticipation
from avt_tpu_torch.data.epic_kitchens import EpicKitchens
from avt_tpu_torch.evaluate import analysis as ta
from avt_tpu_torch.evaluate import results as tres

N_V, N_N, N_A, N_ROWS = 3, 4, 8, 24
TOL = 1e-12


def _tree(root):
    annot = root / "annot"
    annot.mkdir()
    (annot / "EPIC_100_verb_classes.csv").write_text(
        "id,key\n" + "\n".join(f"{i},v{i}" for i in range(N_V)))
    (annot / "EPIC_100_noun_classes.csv").write_text(
        "id,key\n" + "\n".join(f"{i},n{i}" for i in range(N_N)))
    (annot / "actions.csv").write_text(
        "id,verb,noun,action\n" + "\n".join(f"{i},{i % N_V},{i % N_N},a{i}" for i in range(N_A)))
    # two actions 0.5 s in are discarded by the 1 s anticipation shift
    rows = [f"{900 + i},P01_01,15,40,{i % N_V},{i % N_N},{i % N_A}" for i in range(2)]
    rows += [f"{100 + i},P0{1 + i % 2}_01,{600 + i * 150},{690 + i * 150},{i % N_V},"
             f"{(i // 2) % N_N},{(i * 5) % N_A}" for i in range(N_ROWS)]
    (annot / "val.csv").write_text("\n".join(rows))
    # the RULSTM id lists: narration ids, one a line, no header
    nids = [f"P0{1 + i % 2}_01_{100 + i}" for i in range(N_ROWS)]
    for name, keep in (("validation_unseen_participants_ids.csv", nids[1::2]),
                       ("validation_tail_verbs_ids.csv", nids[::3]),
                       ("validation_tail_nouns_ids.csv", nids[1::4]),
                       ("validation_tail_actions_ids.csv", nids[:7])):
        (annot / name).write_text("\n".join(keep) + "\n")
    feats = root / "feats"
    feats.mkdir()
    for v in ("P01_01", "P02_01"):
        np.save(feats / f"{v}.npy", np.zeros((6000, 4), np.float32))
    return annot, feats


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis")
    annot, feats = _tree(root)
    kw = dict(annotation_path=[str(annot / "val.csv")],
              action_labels_fpath=str(annot / "actions.csv"), annotation_dir=str(annot),
              rulstm_annotation_dir=str(annot), version=EPIC100_VERSION, root=str(feats),
              frames_per_clip=4, frame_rate=1.0, label_type=["verb", "noun", "action"],
              sample_strategy="last_clip")
    jds = JEpicKitchens(reader=JNpyFeatsReader(str(feats), read_type="normal"),
                        conv_to_anticipate_fn=lambda d: jconvert(d, 1.0, 10.0), **kw)
    tds = EpicKitchens(reader=NpyFeatsReader(str(feats), read_type="normal"),
                       conv_to_anticipate_fn=lambda d: convert_to_anticipation(d, 1.0, 10.0),
                       **kw)
    nids = [f"P0{1 + (u - 100) % 2}_01_{u}" for u in np.asarray(tds.df["uid"], dtype=int)]
    jds.df["narration_id"] = nids
    tds.df["narration_id"] = nids
    assert len(tds.df) == len(jds.df) == N_ROWS and len(tds.discarded_df) == 2
    return jds, tds, root


def _scores(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N_ROWS, n)) for n in (N_V, N_N, N_A)]


def _same(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert set(got[k]) == set(want[k]), k
            for c in want[k]:
                np.testing.assert_allclose(got[k][c], want[k][c], atol=tol, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_epic_metrics_match_avt_tpu(both, seed):
    jds, tds, _ = both
    probs = _scores(seed)
    want = ja.compute_accuracies_epic(probs, jds)
    got = ta.compute_accuracies_epic(probs, tds)
    assert {"vrec5_tail", "arec5_unseen", "nrec5_ms"} <= set(got)
    _same(got, want)
    _same(ta.epic100_unseen_tail_eval(probs, tds), ja.epic100_unseen_tail_eval(probs, jds))
    assert ta.format_accuracies_epic(got, "x") == ja.format_accuracies_epic(want, "x")


def test_the_id_csv_reader_types_its_column_as_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    for name, text in (("ints", "3\n10\n7\n"), ("floats", "1.5\n2\n"), ("strs", "P01_1\n4\n")):
        (tmp_path / name).write_text(text)
        want = pd.read_csv(tmp_path / name, names=["id"])["id"].tolist()
        got = ta.read_id_csv(tmp_path / name)
        assert got == want and [type(a) for a in got] == [type(a) for a in want], name


def _store_both(tmp_path, arrays):
    jdir, tdir = str(tmp_path / "jres"), str(tmp_path / "tres")
    half = N_ROWS // 2
    for rank, rows in ((0, slice(0, half)), (1, slice(half, None))):
        part = {k: v[rows] for k, v in arrays.items()}
        part["epoch"] = np.asarray([2.5 + rank])
        jres.store_append_h5(part, jdir, rank=rank)
        tres.store_append(part, tdir, rank=rank)
    return jdir, tdir


@pytest.mark.parametrize("stored", ["action", "verb_noun_action"])
def test_marginalized_scores_from_each_sink_match_avt_tpu(both, tmp_path, stored):
    jds, tds, _ = both
    probs = _scores(2)
    arrays = {"logits/action": probs[2], "idx": np.arange(N_ROWS),
              "uid": np.asarray([str(u) for u in tds.df["uid"]])}
    if stored == "verb_noun_action":
        arrays.update({"logits/verb": probs[0], "logits/noun": probs[1]})
    jdir, tdir = _store_both(tmp_path, arrays)
    jacc, jsc = ja.get_marginalized_scores(jdir, jds)
    tacc, tsc = ta.get_marginalized_scores(tdir, tds)
    for got, want in zip(tsc, jsc):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    _same(tacc, jacc, 1e-6)
    assert tres.get_epoch_from_resdir(tdir) == jres.get_epoch_from_resdir(jdir) == 2.5
    tlog = tres.get_logits_from_results(tres.read_results(tdir))
    jlog = jres.get_logits_from_results(jres.read_results(jdir))
    if stored == "action":
        np.testing.assert_array_equal(tlog, jlog)
    else:
        assert sorted(tlog) == sorted(jlog) == ["logits/action", "logits/noun", "logits/verb"]
        for k in jlog:
            np.testing.assert_array_equal(tlog[k], jlog[k])


def test_results_readers_match_avt_tpu(tmp_path):
    arrays = {"logits": np.arange(12.0).reshape(4, 3), "idx": np.arange(4)}
    for suffix in ("", "_test"):
        jres.store_append_h5(arrays, str(tmp_path / "j" / f"results{suffix}"))
        tres.store_append(arrays, str(tmp_path / "t" / f"results{suffix}"))
    jall, tall = jres.read_all_results(str(tmp_path / "j")), tres.read_all_results(
        str(tmp_path / "t"))
    assert sorted(tall) == sorted(jall) == ["results", "results_test"]
    for name in jall:
        np.testing.assert_array_equal(tres.get_logits_from_results(tall[name]),
                                      jres.get_logits_from_results(jall[name]))
    # no epoch stored: None; no logits: KeyError, as in avt_tpu
    assert tres.get_epoch_from_resdir(str(tmp_path / "t" / "results")) is None
    assert jres.get_epoch_from_resdir(str(tmp_path / "j" / "results")) is None
    with pytest.raises(KeyError, match="no logits"):
        tres.get_logits_from_results({"idx": np.arange(2)})


@pytest.mark.parametrize("weights,p", [((2.0, 0.5), None), ((0.3, 0.7), 2), (1.0, 1)])
def test_late_fuse_matches_avt_tpu(both, weights, p):
    jds, tds, _ = both
    runs = [_scores(3), _scores(4)]
    jacc, jcomb = ja.late_fuse([ja.scores_with_uids(s, jds) for s in runs], weights=weights,
                               dataset=jds, normalize_before_combine=p)
    tacc, tcomb = ta.late_fuse([ta.scores_with_uids(s, tds) for s in runs], weights=weights,
                               dataset=tds, normalize_before_combine=p)
    _same(tacc, jacc)
    for tspace, jspace in zip(tcomb, jcomb):
        assert set(tspace) == set(jspace) == {str(u) for u in tds.df["uid"]}
        for uid in jspace:
            np.testing.assert_array_equal(tspace[uid], jspace[uid])
    # a run fused with itself at (0.5, 0.5) is the run
    one = ta.scores_with_uids(runs[0], tds)
    _, self_fused = ta.late_fuse([one, one], weights=[0.5, 0.5])
    for space, orig in zip(self_fused, one):
        assert all(np.array_equal(space[u], orig[u]) for u in orig)


def test_external_scores_load_as_avt_tpu(both, tmp_path):
    jds, tds, _ = both
    _, comb = ta.late_fuse([ta.scores_with_uids(_scores(5), tds)])
    fpath = tmp_path / "ext.json"
    out = ta.struct_outputs(comb, tds)
    for uid in ("900", "901"):  # discarded: keys '0,j' outside this tree's vocabulary
        del out["results"][uid]
    fpath.write_text(json.dumps(out))
    nclasses = (N_V, N_N, N_A)
    tj = ta.load_external_json(str(fpath), tds.verb_noun_to_action, nclasses)
    jj = ja.load_external_json(str(fpath), jds.verb_noun_to_action, nclasses)
    for tspace, jspace in zip(tj, jj):
        assert set(tspace) == set(jspace)
        for uid in jspace:
            np.testing.assert_array_equal(tspace[uid], jspace[uid])
    pkl_path = tmp_path / "ext.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump({f"{s}_scores": comb[i] for i, s in enumerate(("verb", "noun", "action"))},
                    f)
    tp, jp = ta.load_external_pkl(str(pkl_path)), ja.load_external_pkl(str(pkl_path))
    # fused with the run itself, json and pkl, weighted
    _, tf = ta.late_fuse([comb, tj, tp], weights=[1.0, 0.5, 0.25], dataset=tds)
    _, jf = ja.late_fuse([comb, jj, jp], weights=[1.0, 0.5, 0.25], dataset=jds)
    for tspace, jspace in zip(tf, jf):
        for uid in jspace:
            np.testing.assert_array_equal(tspace[uid], jspace[uid])


def _zip_jsons(path):
    with zipfile.ZipFile(path) as zf:
        return {n: json.loads(zf.read(n)) for n in sorted(zf.namelist())}


def test_submission_files_match_avt_tpu(both, tmp_path):
    jds, tds, _ = both
    _, comb = ta.late_fuse([ta.scores_with_uids(_scores(6), tds)])
    out = ta.struct_outputs(comb, tds)
    assert out == ja.struct_outputs(comb, jds)
    # every uid, the discarded ones with uniform scores
    assert set(out["results"]) == {str(u) for u in tds.df["uid"]} | {"900", "901"}
    assert out["results"]["900"]["action"] == {f"0,{j}": 0.0 for j in range(100)}
    ta.package_results_for_submission_ek100(comb, tds, str(tmp_path / "t"), uid_key="uid")
    ja.package_results_for_submission_ek100(comb, jds, str(tmp_path / "j"), uid_key="uid")
    got, want = _zip_jsons(tmp_path / "t" / "submit.zip"), _zip_jsons(tmp_path / "j" /
                                                                       "submit.zip")
    assert list(got) == list(want) == ["test.json"] and got == want
    assert got["test.json"]["sls_pt"] == 1
    ta.package_results_for_submission(comb, tds, comb, tds, str(tmp_path / "t55"))
    ja.package_results_for_submission(comb, jds, comb, jds, str(tmp_path / "j55"))
    got, want = _zip_jsons(tmp_path / "t55" / "submit.zip"), _zip_jsons(tmp_path / "j55" /
                                                                         "submit.zip")
    assert list(got) == list(want) == ["seen.json", "unseen.json"] and got == want


def test_summarize_results_prints_the_same_lines(both, tmp_path, caplog):
    jds, tds, _ = both
    expt = tmp_path / "sweep.txt"
    expt.write_text("model.dropout=0.1,0.2\nseed=1,2\n")
    uids = np.asarray([str(u) for u in tds.df["uid"]])
    for run_id in range(3):  # run 3 never finished: no results
        arrays = {"logits/action": _scores(10 + run_id)[2], "idx": np.arange(N_ROWS),
                  "uid": uids}
        for pkg, store in (("j", jres.store_append_h5), ("t", tres.store_append)):
            store(arrays, str(tmp_path / pkg / "sweep" / str(run_id) / "results"))

    def lines(summary):
        return [f"{' '.join(k)}: runs {v['runs']} mean {v['mean']:.6f} std {v['std']:.6f}"
                for k, v in summary.items()]

    with caplog.at_level(logging.WARNING):
        want = ja.summarize_results(str(expt), str(tmp_path / "j"), dataset_fn=lambda r: jds)
        jlog = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = ta.summarize_results(str(expt), str(tmp_path / "t"), dataset_fn=lambda r: tds)
        tlog = [r.getMessage() for r in caplog.records]
    assert lines(got) == lines(want) and len(got) == 3
    assert [m.split(":")[0] for m in tlog] == [m.split(":")[0] for m in jlog] == [
        "Skipping run 3"]


def test_action_accuracy_of_a_verb_and_a_noun_run_matches_avt_tpu(both, tmp_path):
    jds, tds, _ = both
    probs = _scores(7)
    for task, scores in (("verb", probs[0]), ("noun", probs[1])):
        arrays = {f"logits/{task}": scores, "idx": np.arange(N_ROWS)}
        jres.store_append_h5(arrays, str(tmp_path / "j" / task))
        tres.store_append(arrays, str(tmp_path / "t" / task))
    got = ta.get_epic_action_accuracy(str(tmp_path / "t" / "verb"), tds,
                                      str(tmp_path / "t" / "noun"), tds)
    want = ja.get_epic_action_accuracy(str(tmp_path / "j" / "verb"), jds,
                                       str(tmp_path / "j" / "noun"), jds)
    _same(got, want)


def test_figures_match_avt_tpu(tmp_path):
    pytest.importorskip("matplotlib")
    base = [{0: 10.0, 1: 50.0, 2: 30.0, 3: 5.0}, {0: 12.0, 1: 48.0, 2: 30.0, 3: 7.0}]
    ours = [{0: 40.0, 1: 50.0, 2: 35.0, 4: 9.0}, {0: 42.0, 1: 52.0, 2: 35.0, 4: 1.0}]
    names = {0: "take", 1: "put", 2: "open", 3: "wash", 4: "cut"}
    for kw in ({"show_topn": 2}, {"show_topn": 10},
               {"show_topn": 2, "show_subset": lambda n: n != "take"}):
        fig, got = ta.plot_per_cls_perf([base, ours], ["baseline", "ours"],
                                        cls_id_to_name=names, outfpath=str(tmp_path / "t.pdf"),
                                        **kw)
        _, want = ja.plot_per_cls_perf([base, ours], ["baseline", "ours"],
                                       cls_id_to_name=names, **kw)
        assert got == want
    assert (tmp_path / "t.pdf").stat().st_size > 0
    out = ta.save_graph(fig, "figs/nested/a.pdf", root_dir=str(tmp_path))
    assert os.path.getsize(out) > 0 and not fig.axes[0].spines["top"].get_visible()
    frames = np.random.default_rng(0).integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    for texts in (["take plate", "take plate"], ["take plate", "wash knife"]):
        np.testing.assert_array_equal(ta.overlay_text(frames, texts),
                                      ja.overlay_text(frames, texts))
