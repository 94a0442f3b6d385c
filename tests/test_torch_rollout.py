"""AVT-h beyond one step against avt_tpu on the CPU, at small sizes (2
layers, 4 heads, width 64, T0=6, L in {2, 4}), avt_tpu's weights carried by
`params_from_jax`, in f32 at 2e-5 relative / 1e-5 absolute (JAX's own
tolerance between its two rollout modes): the recompute and KV-cache
rollouts in eval and their train-mode gradients with dropout off, with
return_past_too / avg_last_n / drop_last_n; position-stable dropout with
both sides' masks patched to one table indexed by absolute position (which
checks each pass's and each decode step's offsets); the port's own
position-stable masks (prefix == full slice, cache == recompute, the bits
a function of the seed, the keep rate); attention-map export, also through
the 3-crop AVTModel average; cluster-id inputs with quantize_before_rollout
in both modes; the centroids mode; GPT2Core's clamped position slice; and
one recompute rollout at T0=128 on the flash path (the Pallas kernels in
interpret mode, the port's plain flash versions)."""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avt_tpu.models.layers as jlayers
import avt_tpu_torch.models.layers as tlayers
from avt_tpu.losses import MultiDimCrossEntropy as JMultiDimCrossEntropy
from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityBackbone as JIdentityBackbone,
    LinearClassifier as JLinearClassifier,
)
from avt_tpu.models.layers import GPT2Core as JGPT2Core
from avt_tpu_torch.losses import MultiDimCrossEntropy, mse
from avt_tpu_torch.models import (
    AVTh,
    AVTModel,
    GPT2Core,
    IdentityAgg,
    IdentityBackbone,
    LinearClassifier,
    position_stable_dropout,
)
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 2e-5, 1e-5
B, T0, C, K = 2, 6, 64, 32
SMALL = dict(inter_dim=64, n_layer=2, n_head=4)
DROP = dict(embd_pdrop=0.3, attn_pdrop=0.3, resid_pdrop=0.3)
NO_DROP = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x,
                                                                                     np.float32)


def _close(out, ref, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL, err_msg=what)


def _jloss(p, t):
    return jmse(p, t, reduction="none")


def _tloss(p, t):
    return mse(p, t, reduction="none")


def _pair(in_features=C, jloss=_jloss, tloss=_tloss, **kw):
    """The JAX and port AVTh with the same options."""
    return (JAVTh(in_features=in_features, future_pred_loss=jloss, **SMALL, **kw),
            AVTh(in_features, future_pred_loss=tloss, device="cpu", **SMALL, **kw))


@functools.lru_cache(maxsize=None)
def _jparams(in_features, num_cluster_centers=K):
    """avt_tpu AVTh weights, drawn once for every case of one parameter
    layout: the linear encoder and decoder, or the embedding (cluster ids
    or centroids)."""
    jm = JAVTh(in_features=in_features, num_cluster_centers=num_cluster_centers, output_len=1,
               **SMALL)
    x = jnp.zeros((B, T0, in_features))
    return jax.jit(jm.init)(jax.random.PRNGKey(in_features), x)


def _init(tm):
    """The JAX weights of tm's layout, and tm with them loaded."""
    params = _jparams(1 if tm.quantized_input else tm.in_features)
    return params, load_jax_params(tm, params)


_JREFS = {}


def _jref(what, jm, params, x):
    """avt_tpu's eval forward of `jm` in its recompute mode (which its own
    tests hold equal to its cache mode), jitted once for both of the port's
    modes and kept under `what`."""
    if what not in _JREFS:
        _JREFS[what] = jax.jit(jm.clone(rollout_mode="recompute").apply)(params,
                                                                          jnp.asarray(x))
    return _JREFS[what]


def _compare(out, ref, what):
    (past, final, losses, ends), (jpast, jfinal, jlosses, jends) = out, ref
    assert set(losses) == set(jlosses) and set(ends) == set(jends), what
    _close(past, jpast, f"{what}: updated past")
    _close(final, jfinal, f"{what}: final")
    for k in jlosses:
        _close(losses[k], jlosses[k], f"{what}: loss {k}")
    for k in jends:
        _close(ends[k], jends[k], f"{what}: {k}")


def _objective(out):
    """A scalar of every output, for the gradients."""
    past, final, losses, _ = out
    return sum(v.sum() for v in (past, final, *losses.values()))


def _grads_both(jm, tm, params, x, *, jrngs=None, generator=None):
    """Train-mode objective and gradients on both sides; the port's as
    {name: grad}, JAX's carried over by params_from_jax."""
    def f(p):
        return _objective(jm.apply(p, jnp.asarray(x), train=True, rngs=jrngs))

    jval, jgrad = jax.jit(jax.value_and_grad(f))(params)
    tm.train()
    val = _objective(tm(torch.from_numpy(x), generator=generator))
    val.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    return (val, grads), (jval, params_from_jax(jgrad))


def _scaled_close(out, ref, what):
    """|out - ref| within RTOL of ref's largest magnitude."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= RTOL, f"{what}: max |diff| {err:.3g} of its scale (limit {RTOL})"


def _compare_grads(got, want, what, close=_close):
    (val, grads), (jval, jgrads) = got, want
    _close(val, jval, f"{what}: objective")
    for name, g in grads.items():
        close(g, jgrads[name], f"{what}: d{name}")


ROLLOUT_OPTIONS = {
    "plain": dict(),
    "return_past_too": dict(return_past_too=True),
    "avg_last_n": dict(avg_last_n=2),
    "drop_last_n": dict(drop_last_n=2),
}


@pytest.mark.parametrize("opts", sorted(ROLLOUT_OPTIONS))
@pytest.mark.parametrize("mode", ["recompute", "cache"])
def test_rollout_eval_matches_avt_tpu(mode, opts):
    """An eval rollout of 4 steps (output_len_eval) and the one-step train
    setting's output_len=2 unused at eval."""
    x = _rand((B, T0, C), 1)
    kw = dict(output_len=2, output_len_eval=4, rollout_mode=mode, **ROLLOUT_OPTIONS[opts])
    jm, tm = _pair(**kw)
    params, tm = _init(tm)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    _compare(out, _jref(f"eval {opts}", jm, params, x), f"{mode} {opts}")


@pytest.mark.parametrize("mode", ["recompute", "cache"])
def test_rollout_train_gradients_match_avt_tpu(mode):
    """Training at output_len=2 (dropout off): the objective and every
    parameter's gradient, through both passes and the fed-back token."""
    x = _rand((B, T0, C), 2)
    jm, tm = _pair(output_len=2, return_past_too=True, rollout_mode=mode, **NO_DROP)
    params, tm = _init(tm)
    _compare_grads(*_grads_both(jm, tm, params, x), mode)


@pytest.fixture
def one_mask_table(monkeypatch):
    """Both sides' position-stable dropout patched to one table of
    uniforms indexed by (absolute position, batch row, channel): the masks
    are the same on both sides only where each pass and decode step keys
    its positions right."""
    u = np.random.default_rng(7).uniform(size=(16, B, C)).astype(np.float32)

    def jpsd(x, key, rate, offset=0):
        keep = jnp.asarray(u[offset:offset + x.shape[1]].transpose(1, 0, 2)) < 1.0 - rate
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))

    def tpsd(x, key, rate, offset=0):
        keep = torch.from_numpy(u[offset:offset + x.shape[1]].transpose(1, 0, 2)) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    monkeypatch.setattr(jlayers, "position_stable_dropout", jpsd)
    monkeypatch.setattr(tlayers, "position_stable_dropout", tpsd)


@pytest.mark.usefixtures("one_mask_table")
@pytest.mark.parametrize("mode", ["recompute", "cache"])
def test_rollout_dropout_with_one_mask_table_matches_avt_tpu(mode):
    """Train-time dropout at output_len=4: outputs and gradients."""
    x = _rand((B, T0, C), 3)
    jm, tm = _pair(output_len=4, rollout_mode=mode, **DROP)
    params, tm = _init(tm)
    got, want = _grads_both(jm, tm, params, x, jrngs={"dropout": jax.random.PRNGKey(5)},
                            generator=torch.Generator().manual_seed(5))
    _compare_grads(got, want, mode)


def test_position_stable_prefix_equals_the_full_slice():
    """The port's masks: a GPT2Core pass over a prefix equals the slice of
    the pass over the whole buffer, under the same key (JAX's
    test_rollout_dropout_cache_equiv); and the masks are live."""
    core = GPT2Core(C, n_layer=2, n_head=4, embd_dropout=0.3, attn_dropout=0.3,
                    resid_dropout=0.3, device="cpu").train()
    x = torch.from_numpy(_rand((B, 8, C), 4))
    key = torch.tensor(42)
    with torch.no_grad():
        full = core(x, dropout_key=key)
        for t in (3, 5, 7):
            _close(core(x[:, :t], dropout_key=key), full[:, :t], f"prefix {t}")
        assert not torch.allclose(core.eval()(x), full)


def test_cache_equals_recompute_under_the_ports_own_masks():
    """rollout_mode='cache' against 'recompute' with real position-stable
    masks from one generator seed: outputs, the feat loss and gradients."""
    x = torch.from_numpy(_rand((B, T0, C), 5))
    kw = dict(output_len=4, **SMALL, **DROP, future_pred_loss=_tloss, device="cpu")
    rec = AVTh(C, rollout_mode="recompute", **kw).train()
    cch = AVTh(C, rollout_mode="cache", **kw).train()
    cch.load_state_dict(rec.state_dict())
    outs, grads = [], []
    for m in (rec, cch):
        out = m(x, generator=torch.Generator().manual_seed(9))
        _objective(out).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    _compare(outs[1], outs[0], "cache vs recompute")
    for name, g in grads[0].items():
        _close(grads[1][name], g, f"d{name}")
    # the masks are live: another seed gives other outputs
    other = rec(x, generator=torch.Generator().manual_seed(10))[1]
    assert not torch.allclose(other, outs[0][1])


def test_position_stable_masks_are_a_function_of_the_seed():
    x = torch.ones(8, 64, 256)
    a = position_stable_dropout(x, torch.tensor(3), 0.25)
    b = position_stable_dropout(x, torch.tensor(3), 0.25)
    c = position_stable_dropout(x, torch.tensor(4), 0.25)
    assert torch.equal(a, b) and not torch.equal(a != 0, c != 0)
    assert a.unique().tolist() == [0.0, torch.tensor(1.0 / 0.75).item()]
    n, p = x.numel(), 0.75
    kept = (a != 0).sum().item()
    assert abs(kept - n * p) <= 3 * np.sqrt(n * p * (1 - p)), kept / n
    assert torch.equal(position_stable_dropout(x, torch.tensor(3), 0.0), x)


@pytest.mark.parametrize("mode", ["recompute", "cache"])
def test_output_attentions_match_avt_tpu(mode):
    """gpt2_att_<k> per step of a 3-step rollout, (B, n_layer, n_head, Tq,
    Tk); cache mode takes the recompute path for them, as in JAX."""
    x = _rand((B, T0, C), 6)
    jm, tm = _pair(output_len=3, rollout_mode=mode, output_attentions=True)
    params, tm = _init(tm)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    assert sorted(out[3]) == [f"gpt2_att_{k}" for k in range(3)]
    assert out[3]["gpt2_att_0"].shape == (B, 2, 4, T0, T0)
    assert out[3]["gpt2_att_2"].shape == (B, 2, 4, 1, T0 + 2)
    _compare(out, _jref("attention maps", jm, params, x), f"{mode} attention maps")


def test_attention_maps_average_over_three_crops_as_avt_tpu():
    """Through AVTModel on (B, #clips, 3 crops, C, 1, 1, 1) features: every
    endpoint, the 5-d maps included, averaged over the crops."""
    def fp(cls, **kw):
        return cls(in_features=C, output_len=2, avg_last_n=1, return_past_too=True,
                   output_attentions=True, **SMALL, **kw)

    jm = JAVTModel(backbone=JIdentityBackbone(),
                   temporal_aggregator=JIdentityAgg(in_features=C),
                   future_predictor=fp(JAVTh, future_pred_loss=_jloss),
                   temporal_aggregator_after_future_pred=JIdentityAgg(in_features=C),
                   classifiers={"action": JLinearClassifier(out_features=7)},
                   num_classes=(("action", 7),), backbone_dim=C, classifier_on_past=True)
    tm = AVTModel(backbone=IdentityBackbone(), temporal_aggregator=IdentityAgg(in_features=C),
                  future_predictor=fp(AVTh, future_pred_loss=_tloss, device="cpu"),
                  temporal_aggregator_after_future_pred=IdentityAgg(in_features=C),
                  classifiers={"action": LinearClassifier(C, 7, device="cpu")},
                  num_classes=(("action", 7),), backbone_dim=C, classifier_on_past=True,
                  device="cpu")
    video = _rand((B, T0, 3, C, 1, 1, 1), 7)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video), (B,))
    jout, jaux = jax.jit(jm.apply, static_argnums=2)(params, jnp.asarray(video), (B,))
    tm = load_jax_params(tm, params).eval()
    with torch.no_grad():
        out, aux = tm(torch.from_numpy(video), (B,))
    assert set(out) == set(jout) and {"gpt2_att_0", "gpt2_att_1"} <= set(out)
    assert out["gpt2_att_1"].shape == (B, 2, 4, 1, T0 + 1)
    for k in jout:
        _close(out[k], jout[k], k)
    _close(aux["feat"], jaux["feat"], "feat")


@pytest.mark.parametrize("mode", ["recompute", "cache"])
def test_cluster_id_inputs_with_quantize_before_rollout_match_avt_tpu(mode):
    """in_features == 1: ids in, an nn.Embedding encoder with the decoder
    tied to it, argmax ids re-encoded between steps, hidden states out
    (output_dim is inter_dim), a cross-entropy feat loss over the ids."""
    ids = np.random.default_rng(8).integers(0, K, size=(B, T0, 1)).astype(np.float32)
    jm, tm = _pair(1, jloss=JMultiDimCrossEntropy(), tloss=MultiDimCrossEntropy(),
                   output_len=4, num_cluster_centers=K, quantize_before_rollout=True,
                   rollout_mode=mode, return_past_too=True)
    params, tm = _init(tm)
    assert tm.output_dim == 64 and tm.decoder.weight is tm.encoder.weight
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(ids))
    assert out[1].shape == (B, T0 + 4, 64)
    _compare(out, _jref("cluster ids", jm, params, ids), f"{mode} cluster ids")


def _centroids():
    """K well-separated centroids and features near them, so that rounding
    cannot flip an assignment."""
    cents = 4.0 * np.eye(K, C, dtype=np.float32) + 0.1 * _rand((K, C), 9)
    ids = np.random.default_rng(10).integers(0, K, size=(B, T0))
    return cents, cents[ids] + 0.05 * _rand((B, T0, C), 11), ids


@pytest.mark.parametrize("mode", ["recompute", "cache"])
def test_centroids_mode_matches_avt_tpu(mode):
    """Features assigned to their nearest centroid on the way in, the
    predicted ids' centroids on the way out."""
    cents, feats, _ = _centroids()
    jm, tm = _pair(jloss=JMultiDimCrossEntropy(), tloss=MultiDimCrossEntropy(),
                   output_len=2, num_cluster_centers=K, centroids=cents,
                   rollout_mode=mode, return_past_too=True)
    params, tm = _init(tm)
    assert tm.output_dim == C
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(feats))
    _compare(out, _jref("centroids", jm, params, feats), f"{mode} centroids")


def test_position_slice_clamps_as_jax(monkeypatch):
    """GPT2Core's wpe slice at an offset past n_positions - T starts at
    n_positions - T, as jax.lax.dynamic_slice_in_dim clamps it."""
    x = _rand((B, 4, C), 12)
    jm = JGPT2Core(n_layer=1, n_head=4, n_positions=8)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = load_jax_params(GPT2Core(C, n_layer=1, n_head=4, n_positions=8, device="cpu"), params)
    with torch.no_grad():
        for offset in (3, 9):
            ref = jax.jit(functools.partial(jm.apply, position_offset=offset))(
                params, jnp.asarray(x))
            _close(tm.eval()(torch.from_numpy(x), offset), ref, f"offset {offset}")
        with pytest.raises(ValueError, match="n_positions"):
            tm(torch.from_numpy(_rand((B, 9, C), 13)))


def test_rollout_mode_is_validated():
    with pytest.raises(ValueError, match="rollout_mode"):
        AVTh(C, rollout_mode="nope", device="cpu", **SMALL)


def test_rollout_at_128_tokens_on_the_flash_path_matches_avt_tpu(monkeypatch):
    """A recompute rollout of 2 steps from T0=128: both passes (128 and 129
    tokens) through flash attention, the Pallas kernels in interpret mode
    on the JAX side, the port's plain flash versions; the objective, and
    each gradient within 2e-5 of its largest magnitude (sums over 129
    tokens put a few near-zero entries past the absolute 1e-5)."""
    monkeypatch.setattr(jlayers, "dot_product_attention",
                        functools.partial(jlayers.dot_product_attention, use_pallas=True))
    monkeypatch.setattr(tlayers, "dot_product_attention",
                        functools.partial(tlayers.dot_product_attention, use_kernel=True))
    calls = mock.Mock(wraps=tfa.flash_attention)
    monkeypatch.setattr(tfa, "flash_attention", calls)
    x = _rand((1, 128, C), 14)
    jm, tm = _pair(output_len=2, return_past_too=True, **NO_DROP)
    params, tm = _init(tm)
    _compare_grads(*_grads_both(jm, tm, params, x), "flash path", close=_scaled_close)
    assert calls.call_count == 2 * 2 and all(c.args[3] is True for c in calls.call_args_list)
