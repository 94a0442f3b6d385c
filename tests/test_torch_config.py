"""The port's config layer against avt_tpu's and PyYAML.

The port reads YAML with its own reader (`avt_tpu_torch.config.overrides.
yaml_load`), since its package imports no PyYAML. Compared here: the reader
with `yaml.safe_load` on every conf/**/*.yaml file (with ${...} stashed,
as both packages parse them) and on YAML 1.1 edge scalars; `parse_value`
with avt_tpu's on every override value of every expts/*.txt file (sweep
elements included) and on quoted, flow and scientific values; the composed
config of every sweep variant of every experiment file with avt_tpu's
`Composer`; the registry's targets, and its refusals of those not ported
(a target ported since, QuantizeAndCrossEntropy, now builds expts/02's
future loss and matches avt_tpu on one eval forward).
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from avt_tpu.config import Composer as JComposer
from avt_tpu.config import expand_sweeps as jexpand_sweeps
from avt_tpu.config import parse_overrides_file as jparse_overrides_file
from avt_tpu.config import parse_override as jparse_override
from avt_tpu.config.build import build_model as jbuild_model
from avt_tpu.config.registry import instantiate as jinstantiate
from avt_tpu.config.compose import load_yaml as jload_yaml
from avt_tpu.config.overrides import _split_top_level_commas
from avt_tpu.config.overrides import parse_value as jparse_value
from avt_tpu_torch.config import (
    Composer,
    expand_sweeps,
    instantiate,
    load_yaml,
    parse_override,
    parse_overrides_file,
    parse_value,
    resolve_target,
    yaml_load,
)
from avt_tpu_torch.config.overrides import (
    YAMLSubsetError,
    _QuotedStr,
    plain,
    stash_interpolations,
)
from avt_tpu_torch.config.build import build_model
from avt_tpu_torch.models.convert import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
CONF_DIR = ROOT / "conf"
CONF_FILES = sorted(CONF_DIR.rglob("*.yaml"))
EXPTS = sorted((ROOT / "expts").glob("*.txt"))


def _override_values():
    """Every value of every override line in expts/, and each element of a
    sweep."""
    values = set()
    for path in EXPTS:
        for line in path.read_text().splitlines():
            line = line.split("#")[0].strip()
            if "=" not in line:
                continue
            raw = line.split("=", 1)[1]
            values.add(raw)
            parts = _split_top_level_commas(raw)
            if len(parts) > 1:
                values.update(p.strip() for p in parts)
    return sorted(values)


EXPT_VALUES = _override_values()
# scientific numbers with and without a dot, quoted and not, at any depth;
# flow collections; YAML 1.1 booleans and nulls; interpolations in flows
EXTRA_VALUES = [
    "1e-6", "1E+3", "-2e5", "1.0e-6", "1.0e6", "0.000001", "'1e-6'", '"1e-6"',
    "[1e-6, '1e-6', 0.1]", "{a: 1e-6, b: '2e-3', 1e-4: c}", "[[__all__,0.001,0.000001]]",
    "{_target_: torch.nn.MSELoss}", '"no"', "'yes'", "no", "yes", "On", "off", "~", "null",
    "Null", "", "true", "False", "012", "0x1F", "1_000", "+7", "-0", ".5", "1:30", ".inf",
    "-.Inf", "[a: b]", "{a}", "[a, b, ]", "a: b", "- a", "a b  c", "a #b", "a#b", "[a",
    "{a: [1, {b: ${x.y}}]}", "${a.b}/c d", "'it''s'", '"tab\\there"', "2001-12-14",
    "[${cwd}/x.pth, y]", "{k: ${a}, ${b}: v}",
]


def _jax_equal(a, b):
    """Equal values of equal types, NaN equal to NaN, at any depth."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_jax_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_jax_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", CONF_FILES, ids=lambda p: str(p.relative_to(CONF_DIR)))
def test_yaml_reader_matches_pyyaml_on_conf(path):
    text, _ = stash_interpolations(path.read_text())
    ours = yaml_load(text)
    assert _jax_equal(plain(ours), yaml.safe_load(text))
    assert _jax_equal(load_yaml(path), jload_yaml(path))


def test_conf_files_are_all_compared():
    assert len(CONF_FILES) == 55


YAML_CASES = [
    "1e-6", "1.0e5", "1.0e+5", "0.000001", "~", "null", "", "a: b", "- a", "[a: b]", "{a}",
    "'x'", '"no"', "0o7", "012", "08", "0x1F", "0b101", "1_000", "+1", ".5", "1.", "1:30",
    "yes", "On", "OFF", "[1, [2, 3], {a: 1}]", "{a: [1,2], b: c d}", "a#b", "a #b", "[a,b,]",
    "a:b", "{a:b}", "[http://x]", "foo bar  baz", "2001-12-14", "-", "-.inf", ".NaN",
    "'it''s'", '"a\\tb"', "[ ]", "{ }", "a,b", "[a b, c]", "-1", "- ", "a:", "{a: }",
    "[a, ]", "a : b", "[a , b ]", "{a : 1 , b: [x , y]}", "key: [a, b] # c", "a: 'b' # c",
    "[-1, -x, -]", "a:\n  b: 1\n  c:\n  - x\n  - y: 2\n    z: 3\nd: [1]",
    "- a\n-\n  - b\n- c: d", "a:\n- 1\n- 2", "x: 'q' # c\n# only a comment\ny: \"r\"",
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_matches_pyyaml_on_scalars_and_blocks(text):
    assert _jax_equal(plain(yaml_load(text)), yaml.safe_load(text))


@pytest.mark.parametrize("text", ["a: b: c", "[a", "{a: b", "'open", "&x a", "!!str 5", "|",
                                  "a:\n  b\n  c", "=", "a:\n\tb: 1"])
def test_yaml_reader_refuses_what_pyyaml_refuses_or_the_subset_leaves_out(text):
    with pytest.raises(YAMLSubsetError):
        yaml_load(text)


def test_yaml_reader_keeps_the_quote_style():
    v = yaml_load("{a: 'x', b: y, c: [\"z\"]}")
    assert isinstance(v["a"], _QuotedStr) and not isinstance(v["b"], _QuotedStr)
    assert isinstance(v["c"][0], _QuotedStr)


@pytest.mark.parametrize("raw", EXPT_VALUES + EXTRA_VALUES)
def test_parse_value_matches_avt_tpu(raw):
    assert _jax_equal(parse_value(raw), jparse_value(raw)), raw


def test_expt_values_cover_every_kind():
    assert len(EXPT_VALUES) >= 96
    kinds = {type(parse_value(v)) for v in EXPT_VALUES}
    assert {int, float, bool, str, list, dict} <= kinds


@pytest.mark.parametrize("expt", EXPTS, ids=lambda p: p.stem)
def test_compose_matches_avt_tpu(expt):
    ours = expand_sweeps(parse_overrides_file(expt))
    ref = jexpand_sweeps(jparse_overrides_file(expt))
    assert len(ours) == len(ref)
    for variant, jvariant in zip(ours, ref):
        cfg = Composer(CONF_DIR).compose("config", variant)
        jcfg = JComposer(CONF_DIR).compose("config", jvariant)
        assert _jax_equal(cfg, jcfg)


def test_every_expt_is_composed():
    assert len(EXPTS) == 27
    variants = sum(len(expand_sweeps(parse_overrides_file(e))) for e in EXPTS)
    assert variants > len(EXPTS)  # the sweeps expand


# expts/02 at a small width (AVT-h of 1 layer, 64 wide, 2 heads; dropout off)
EXPT02_SMALL = ["model.future_predictor.n_layer=1", "model.future_predictor.inter_dim=64",
                "model.future_predictor.n_head=2", "model.dropout=0.0",
                "+model.future_predictor.embd_pdrop=0.0",
                "+model.future_predictor.attn_pdrop=0.0",
                "+model.future_predictor.resid_pdrop=0.0"]
PORTED_ITEMS = ("1.5",)  # ROADMAP items whose targets raised until they were ported


def _expt02_future_loss_matches_avt_tpu(target, tmp_path):
    """expts/02 with `target` as AVT-h's future loss (on 16 centroids of the
    1024-d features, written as .npy): both packages' build_model, one eval
    forward from avt_tpu's weights; logits and the feat loss at 2e-4."""
    cents = np.random.default_rng(0).standard_normal((16, 1024)).astype(np.float32)
    np.save(tmp_path / "cents.npy", cents)
    overrides = EXPT02_SMALL + [
        f"model.future_predictor.future_pred_loss={{_target_: {target}, "
        f"centroids_fpath: {tmp_path / 'cents.npy'}}}"]
    expt = ROOT / "expts" / "02_ek100_avt_tsn.txt"
    cfg = Composer(CONF_DIR).compose("config", expand_sweeps(
        parse_overrides_file(expt) + [parse_override(o) for o in overrides])[0])
    jcfg = JComposer(CONF_DIR).compose("config", jexpand_sweeps(
        jparse_overrides_file(expt) + [jparse_override(o) for o in overrides])[0])
    num_classes = {"action": 7}
    video = np.random.default_rng(1).standard_normal((2, 10, 1024, 1, 1, 1)).astype(np.float32)
    jm = jbuild_model(jcfg, num_classes, {})
    params = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), jnp.asarray(video), (2,))
    jout, jaux = jax.jit(jm.apply, static_argnums=2)(params, jnp.asarray(video), (2,))
    model = load_jax_params(build_model(cfg, num_classes, {}, device="cpu"), params)
    with torch.no_grad():
        out, aux = model(torch.from_numpy(video), (2,))
    assert aux["feat"].shape == (2, 9)
    for got, want in ((out["logits/action"], jout["logits/action"]), (aux["feat"], jaux["feat"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("target,item", [
    ("loss_fn.simclr_infonce.MultiDimDistributedSimclrInfoNCELoss", "1.8"),
    ("loss_fn.multidim_xentropy.QuantizeAndCrossEntropy", "1.5"),
])
def test_unported_targets_raise_naming_their_roadmap_item(target, item, tmp_path):
    """A target still to port raises naming its ROADMAP item. Those ported
    since: QuantizeAndCrossEntropy (item 1.5) builds its module in expts/02
    and matches avt_tpu; the InfoNCE (item 1.8), as
    train_eval_op/reg_criterion=simclr_infonce composes it, gives avt_tpu's
    loss on the same (2, 5, 16) embeddings."""
    if item == "1.8":
        cfg = Composer(CONF_DIR).compose("config", [parse_override(
            "train_eval_op/reg_criterion=simclr_infonce")])
        crit = cfg["train_eval_op"]["reg_criterion"]
        assert crit["_target_"] == target
        rng = np.random.default_rng(0)
        out, tgt = (rng.standard_normal((2, 5, 16)).astype(np.float32) for _ in range(2))
        ours = instantiate(crit)(torch.from_numpy(out), torch.from_numpy(tgt))
        ref = jinstantiate(crit)(jnp.asarray(out), jnp.asarray(tgt))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
        return
    if item in PORTED_ITEMS:
        _expt02_future_loss_matches_avt_tpu(target, tmp_path)
        return
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue {item}"):
        instantiate({"_target_": target})


# the targets that raised until the raw-video readers and 50Salads were ported
PORTED_TARGETS = {
    "datasets.breakfast_50salads.Breakfast50Salads": "Breakfast50Salads",
    "datasets.breakfast_50salads.SenerFeatsReader": "SenerFeatsReader",
    "avt_tpu.data.Breakfast50Salads": "Breakfast50Salads",
    "datasets.reader_fns.DefaultReader": "LibavVideoReader",
    "avt_tpu.data.LibavVideoReader": "LibavVideoReader",
}


@pytest.mark.parametrize("target", [None] + sorted(PORTED_TARGETS))
def test_targets_map_onto_the_port(target):
    import avt_tpu_torch.data as tdata
    import avt_tpu_torch.losses as tlosses
    from avt_tpu_torch.data import breakfast_50salads, video_decoder

    if target is not None:
        fn = resolve_target(target)
        if PORTED_TARGETS[target] == "LibavVideoReader":  # the DefaultReader rule
            assert type(fn()) is video_decoder.LibavVideoReader
        else:
            assert fn is getattr(breakfast_50salads, PORTED_TARGETS[target])
        return
    assert resolve_target("datasets.epic_kitchens.EPICKitchens") is tdata.EpicKitchens
    assert resolve_target("datasets.epic_kitchens.EpicRULSTMFeatsReader") is tdata.LMDBFeatsReader
    assert resolve_target("avt_tpu.data.NpyFeatsReader") is tdata.NpyFeatsReader
    assert resolve_target("torch.nn.MSELoss") is tlosses.MSELoss
    loss = instantiate({"_target_": "torch.nn.MSELoss"}, reduction="none")
    assert loss.reduction == "none"
    with pytest.raises(KeyError):
        resolve_target("no.such.Target")
