"""The last public entry points of avt_tpu that the port lacked, against
their avt_tpu counterparts on the CPU: `config.compose` (the module-level
helper over `Composer`) on expts/02's overrides, and
`train.step.make_forward_fn` (the plain forward, the whole outputs dict in
eval mode) on a narrow 2-layer feature-path model whose weights come from
the JAX model through `params_from_jax`. (`multi_head_attention` is held
in test_torch_mha.py.)"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.config import compose as jcompose
from avt_tpu.config import parse_overrides_file as jparse_overrides_file
from avt_tpu.models.flagship import build_avt as jbuild_avt
from avt_tpu.train.step import make_forward_fn as jmake_forward_fn
from avt_tpu_torch import build_avt
from avt_tpu_torch.config import compose, parse_overrides_file
from avt_tpu_torch.models.convert import load_jax_params
from avt_tpu_torch.train.step import make_forward_fn

ROOT = Path(__file__).resolve().parents[1]
CONF_DIR = ROOT / "conf"
EXPT_02 = ROOT / "expts" / "02_ek100_avt_tsn.txt"
# f32, the same math summed in another order: every output within 2e-4 of
# its max |value|
TOL = 2e-4


def _equal(a, b):
    """Equal values of equal types, NaN equal to NaN, at any depth."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _expt_lines(path):
    lines = (line.split("#")[0].strip() for line in path.read_text().splitlines())
    return [line for line in lines if line]


@pytest.mark.parametrize("form", ["strings", "parsed-unresolved"])
def test_compose_matches_avt_tpu_on_expts_02(form):
    """compose(conf_dir, "config", overrides, resolve): expts/02's lines as
    strings, resolved, and as each package's parsed overrides, unresolved."""
    if form == "strings":
        cfg = compose(CONF_DIR, overrides=_expt_lines(EXPT_02))
        jcfg = jcompose(CONF_DIR, overrides=_expt_lines(EXPT_02))
        assert cfg["train"]["batch_size"] == 64 and "${" not in str(cfg)
    else:
        cfg = compose(str(CONF_DIR), "config", parse_overrides_file(EXPT_02), resolve=False)
        jcfg = jcompose(str(CONF_DIR), "config", jparse_overrides_file(EXPT_02), resolve=False)
        assert "${" in str(cfg)
    assert _equal(cfg, jcfg)


def test_make_forward_fn_matches_avt_tpu():
    """The feature path (identity backbone, AVT-h of 2 layers of 2 heads, 64
    wide, 40 actions) over 10 features: every output of the forward."""
    B, T, feat, actions = 2, 10, 32, 40
    avth = dict(inter_dim=64, n_layer=2, n_head=2)
    video = np.random.default_rng(0).standard_normal((B, T, feat, 1, 1, 1)).astype(np.float32)
    jm = jbuild_avt(num_actions=actions, backbone="identity", backbone_dim=feat, **avth)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video), (B,))
    ref = jmake_forward_fn(jm)(params, jnp.asarray(video))
    model = build_avt(num_actions=actions, backbone="identity", backbone_dim=feat, device="cpu",
                      seed=0, **avth)
    load_jax_params(model, params)
    model.train()  # the forward switches to eval mode itself
    out = make_forward_fn(model)(torch.from_numpy(video))
    assert not model.training
    assert set(out) == set(ref) and "logits/action" in out
    for key, want in ref.items():
        got = out[key]
        want = np.asarray(want, np.float32)
        assert not got.requires_grad and tuple(got.shape) == want.shape, key
        err = np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-6)
        assert err <= TOL, f"{key}: {err:.3g} of max |ref|"
