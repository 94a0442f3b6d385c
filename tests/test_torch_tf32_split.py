"""The numerics of the f32 forms of the packed attention kernels and of the
flash backward, emulated on the CPU.

On the card the f32 products run on the tensor cores as three TF32 products:
each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
a . b = lo_a . hi_b + hi_a . lo_b + hi_a . hi_b (csrc/tensor_core.cuh).
Here TF32 rounding is done with integer bit operations on float32 (10
mantissa bits kept; to nearest with ties away from zero, as cvt.rna.tf32.f32
rounds, or by truncation, as CUTLASS takes hi and the flash backward takes
hi and lo: the tensor cores ignore an operand's 13 low bits), the products of
TF32 values are exact, and the kernels are computed in
their order, then held against the plain versions: the packed forward and
backward at the ViT's T=197, D=64 with the qkv bias and q's scaling; the
flash forward (the online softmax over the kernel's key tiles, p split
before p . v) and the flash backward's dq side and dk/dv side at D=64, 512
and 1024 and at Tq != Tk, also against avt_tpu's `_flash_attention_fwd` and
`_flash_attention_bwd` in interpret mode. Three terms stay ten times inside
the card's f32 tolerance of 2e-4 (of max |ref|); one term alone does not
meet it on either backward, and leaves the flash forward's error many times
the three terms'.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avt_tpu.ops import flash_attention as jfa
from avt_tpu_torch.ops import flash_attention as tfa

N, T, H, D = 2, 197, 2, 64
CARD_TOL = 2e-4  # chip_smoke.py's f32 tolerance for the kernels
SPLIT_TOL = 2e-5


def tf32(x: torch.Tensor, rounding: str = "rna") -> torch.Tensor:
    """float32 x with its 13 low mantissa bits cleared: "rna" rounds to
    nearest, ties away from zero (adding half of the last kept bit to the
    magnitude); "truncate" drops them."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def split_product(hi_rounding="rna", terms=3, lo_rounding="rna"):
    """a @ b as the kernels form it: three TF32 terms (lo.hi + hi.lo +
    hi.hi), or with terms=1 one TF32 product; lo rounded by `lo_rounding`
    (the packed kernels: rna; the flash backward: truncate, as for hi)."""
    def mm(a, b):
        a_hi, b_hi = tf32(a, hi_rounding), tf32(b, hi_rounding)
        out = a_hi.double() @ b_hi.double()
        if terms == 3:
            a_lo, b_lo = tf32(a - a_hi, lo_rounding), tf32(b - b_hi, lo_rounding)
            out = a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double() + out
        return out.float()
    return mm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((N, T, 3 * H * D), np.float32))
    bias = torch.from_numpy(rng.standard_normal(3 * H * D, np.float32))
    dout = torch.from_numpy(rng.standard_normal((N, T, H * D), np.float32))
    return qkv, bias, dout


def _heads(x):
    return x.reshape(N, T, H, D).transpose(1, 2)


def _merge(x):
    return x.transpose(1, 2).reshape(N, T, H * D)


def _scores(qkv, bias, mm):
    """q' (biased, scaled in f32), k, v and the probabilities against the row
    max, with s = q' . k^T from `mm`."""
    q, k, v = (_heads(x) for x in (qkv + bias).split(H * D, dim=-1))
    qs = q * torch.tensor(tfa._storage_scale(D, torch.float32))
    s = mm(qs, k.transpose(-1, -2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return qs, k, v, p


def emulated_forward(qkv, bias, mm):
    """out = (p . v) / rowsum(p), the products from `mm`."""
    _, _, v, p = _scores(qkv, bias, mm)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return _merge(mm(p, v) / l)


def emulated_backward(qkv, bias, dout, mm):
    """dqkv in the kernels' order (query side: dq = (ds . k) * sm_scale / l;
    key side: dk = ((ds / l)^T . q') / log2 e, dv = (p / l)^T . dO), the
    products from `mm`."""
    qs, k, v, p = _scores(qkv, bias, mm)
    do = _heads(dout)
    il = 1.0 / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dp = mm(do, v.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True) * il
    ds = p * (dp - delta)
    dq = mm(ds, k) * (il * (1.0 / math.sqrt(D)))
    dk = mm((ds * il).transpose(-1, -2), qs) * math.log(2.0)
    dv = mm((p * il).transpose(-1, -2), do)
    return torch.cat([_merge(x) for x in (dq, dk, dv)], dim=-1)


def _rel_err(out, ref):
    return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


@pytest.mark.parametrize("value,rounding,want", [
    (1 + 2 ** -11, "rna", 1 + 2 ** -10),   # a tie rounds away from zero
    (-(1 + 2 ** -11), "rna", -(1 + 2 ** -10)),
    (1 + 2 ** -12, "rna", 1.0),            # under half of the last kept bit
    (1 + 3 * 2 ** -12, "rna", 1 + 2 ** -10),
    (1 + 2 ** -11, "truncate", 1.0),
    (-(1 + 2 ** -10 + 2 ** -11), "truncate", -(1 + 2 ** -10)),
])
def test_tf32_rounding(value, rounding, want):
    assert tf32(torch.tensor([value], dtype=torch.float32), rounding).item() == want


def test_split_is_exact_to_tf32_twice():
    """hi + lo leaves at most half of lo's last kept bit: ~2^-22 of |x|."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096, np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert ((hi + lo).double() - x.double()).abs().max() <= 2.0 ** -22 * x.abs().max()


@pytest.mark.parametrize("hi_rounding", ["rna", "truncate"])
def test_three_term_forward_matches_plain_version(hi_rounding):
    qkv, bias, _ = _inputs()
    ref = tfa.packed_short_attention_reference(qkv + bias, H)
    out = emulated_forward(qkv, bias, split_product(hi_rounding))
    assert _rel_err(out, ref) <= SPLIT_TOL


@pytest.mark.parametrize("hi_rounding", ["rna", "truncate"])
def test_three_term_backward_matches_plain_version(hi_rounding):
    qkv, bias, dout = _inputs()
    ref, _ = tfa.packed_short_attention_bwd_reference(qkv + bias, dout, H)
    out = emulated_backward(qkv, bias, dout, split_product(hi_rounding))
    assert _rel_err(out, ref) <= SPLIT_TOL


def test_one_term_backward_misses_the_card_tolerance():
    """Why the kernels take three terms: one TF32 product a term leaves the
    backward outside the f32 tolerance."""
    qkv, bias, dout = _inputs()
    ref, _ = tfa.packed_short_attention_bwd_reference(qkv + bias, dout, H)
    out = emulated_backward(qkv, bias, dout, split_product(terms=1))
    assert _rel_err(out, ref) > CARD_TOL


# (Tq, Tk, H, D, causal): the Transformer aggregator's non-causal D=64,
# AVT-h's causal D=512 and D=1024, and fewer queries than keys
FLASH_CASES = [
    pytest.param(40, 40, 2, 64, False, id="D64"),
    pytest.param(40, 40, 2, 512, True, id="D512-causal"),
    pytest.param(40, 40, 2, 1024, True, id="D1024-causal"),
    pytest.param(24, 40, 2, 512, True, id="Tq24-Tk40-D512-causal"),
]


def _flash_inputs(Tq, Tk, H, D, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((2, Tq, H, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, Tk, H, D), np.float32) for _ in range(2))
    return q, k, v, do


def emulated_flash_backward(q, k, v, dout, lse, delta, causal, mm):
    """(dq, dk, dv) in the order of csrc/flash_attention_bwd.cu, f32 (B, T,
    H, D) in and out, the products from `mm`. q' = q * sm_scale; the dq side
    keeps the queries: s = q' . K^T, p = exp(s - lse) (0 where masked), ds =
    p * (dO . V^T - delta), dq = (ds . K) * sm_scale. The dk/dv side keeps the
    keys and forms its own scores, K . q'^T and V . dO^T: dk = ds^T . q', dv
    = p^T . dO."""
    D = q.shape[-1]
    qs, kh, vh, doh = (x.transpose(1, 2) for x in (q * tfa._flash_scale(D, q.dtype), k, v, dout))
    Tq, Tk = q.shape[1], k.shape[1]
    keep = (tfa._causal_keep(Tq, 0, Tk, q.device) if causal
            else torch.ones(Tq, Tk, dtype=torch.bool))
    sm_scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)

    def probs(s, dp, lse_, delta_, keep_):
        p = torch.where(keep_, torch.exp(s - lse_), torch.zeros(()))
        return p, p * (dp - delta_)

    _, ds = probs(mm(qs, kh.transpose(-1, -2)), mm(doh, vh.transpose(-1, -2)),
                  lse[..., None], delta[..., None], keep)
    dq = mm(ds, kh) * sm_scale
    p_t, ds_t = probs(mm(kh, qs.transpose(-1, -2)), mm(vh, doh.transpose(-1, -2)),
                      lse[..., None, :], delta[..., None, :], keep.transpose(-1, -2))
    dk, dv = mm(ds_t, qs), mm(p_t, doh)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _flash_case(Tq, Tk, H, D, causal, mm, with_tpu_kernels=True):
    """The emulated backward, the plain version's and (with_tpu_kernels)
    avt_tpu's `_flash_attention_bwd` in interpret mode, all three from the
    plain forward's lse and delta (padded to the TPU kernel's 128-row block:
    its padded query rows have dO = 0 and contribute nothing)."""
    q, k, v, do = _flash_inputs(Tq, Tk, H, D, seed=Tq + D)
    tx = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = tfa.flash_attention_reference(*tx[:3], causal)
    delta = tfa._delta(tx[3], out)
    got = emulated_flash_backward(*tx, lse, delta, causal, mm)
    ref = tfa.flash_attention_bwd_reference(*tx, out, lse, causal)
    if not with_tpu_kernels:
        return got, ref, None
    pad = ((0, 0), (0, 0), (0, 128 - Tq))
    jlse, jdelta = (jnp.pad(jnp.asarray(x.numpy()), pad) for x in (lse, delta))
    jref = jfa._flash_attention_bwd(*(jnp.asarray(x) for x in (q, k, v, do)), jlse, jdelta,
                                    causal=causal, block_q=128, block_k=128, interpret=True)
    return got, ref, [torch.from_numpy(np.array(x)) for x in jref]


@pytest.mark.parametrize("Tq,Tk,H,D,causal", FLASH_CASES)
def test_three_term_flash_backward_matches_plain_version_and_tpu_kernels(Tq, Tk, H, D, causal):
    """dq (dq side), dk and dv (dk/dv side) with three TF32 terms a product,
    hi and lo truncated, as the kernel splits (split_tf32_rz)."""
    mm = split_product("truncate", lo_rounding="truncate")
    got, ref, jref = _flash_case(Tq, Tk, H, D, causal, mm)
    for name, g, r, j in zip("qkv", got, ref, jref):
        assert _rel_err(g, r) <= SPLIT_TOL, f"d{name} vs the plain version"
        assert _rel_err(g, j) <= SPLIT_TOL, f"d{name} vs _flash_attention_bwd"


def test_one_term_flash_backward_misses_the_card_tolerance():
    """Why the flash backward takes three terms: at D=512 one TF32 product a
    term leaves dq or dk outside the f32 tolerance."""
    got, ref, _ = _flash_case(40, 40, 2, 512, True, split_product(terms=1),
                              with_tpu_kernels=False)
    assert max(_rel_err(got[0], ref[0]), _rel_err(got[1], ref[1])) > CARD_TOL


# the f32 forward's key tile (csrc/flash_attention_common.cuh: Tiling's BN
# for the forward), by head dim
FLASH_FWD_BN = {64: 32, 128: 32, 256: 16, 512: 8, 1024: 8}


def emulated_flash_forward(q, k, v, causal, mm):
    """(out (B, Tq, H, D), lse (B, H, Tq)) in the order of
    csrc/flash_attention_fwd.cu, f32 in and out, the products from `mm`:
    q' = q * sm_scale, then over the kernel's key tiles s = q' . K^T (-1e30
    where masked), m' = max(m, rowmax s), p = exp(s - m'), l = l * exp(m -
    m') + rowsum p, acc = acc * exp(m - m') + p . V (p split as the kernel's
    W planes); out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    D = q.shape[-1]
    qs, kh, vh = (x.transpose(1, 2) for x in (q * tfa._flash_scale(D, q.dtype), k, v))
    Tq, Tk = q.shape[1], k.shape[1]
    keep = (tfa._causal_keep(Tq, 0, Tk, q.device) if causal
            else torch.ones(Tq, Tk, dtype=torch.bool))
    m = torch.full((*qs.shape[:3], 1), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    bn = FLASH_FWD_BN[D]
    for k0 in range(0, Tk, bn):
        s = torch.where(keep[:, k0:k0 + bn], mm(qs, kh[:, :, k0:k0 + bn].transpose(-1, -2)),
                        torch.tensor(tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + mm(p, vh[:, :, k0:k0 + bn])
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc).transpose(1, 2), (m + torch.log(lc))[..., 0]


def _flash_fwd_case(Tq, Tk, H, D, causal, mm, with_tpu_kernel=True):
    """The emulated forward, the plain version's and (with_tpu_kernel)
    avt_tpu's `_flash_attention_fwd` in interpret mode (lse cut to Tq)."""
    q, k, v, _ = _flash_inputs(Tq, Tk, H, D, seed=Tq + D + 1)
    tx = [torch.from_numpy(x) for x in (q, k, v)]
    got = emulated_flash_forward(*tx, causal, mm)
    ref = tfa.flash_attention_reference(*tx, causal)
    if not with_tpu_kernel:
        return got, ref, None
    jout, jlse = jfa._flash_attention_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                          block_q=128, block_k=128, interpret=True,
                                          want_lse=True)
    return got, ref, (torch.from_numpy(np.array(jout)), torch.from_numpy(np.array(jlse)[..., :Tq]))


@pytest.mark.parametrize("Tq,Tk,H,D,causal", FLASH_CASES)
def test_three_term_flash_forward_matches_plain_version_and_tpu_kernel(Tq, Tk, H, D, causal):
    """out and lse with three TF32 terms a product, hi and lo truncated, as
    the kernel splits (split_tf32_rz)."""
    mm = split_product("truncate", lo_rounding="truncate")
    got, ref, jref = _flash_fwd_case(Tq, Tk, H, D, causal, mm)
    for name, g, r, j in zip(("out", "lse"), got, ref, jref):
        assert _rel_err(g, r) <= SPLIT_TOL, f"{name} vs the plain version"
        assert _rel_err(g, j) <= SPLIT_TOL, f"{name} vs _flash_attention_fwd"


@pytest.mark.parametrize("D", [512, 1024])
def test_one_term_flash_forward_misses_the_card_tolerance(D):
    """Why the flash forward takes three terms: at AVT-h's head dims one
    TF32 product a term (hi rounded to nearest) leaves out outside the f32
    tolerance."""
    got, ref, _ = _flash_fwd_case(40, 40, 2, D, True, split_product(terms=1),
                                  with_tpu_kernel=False)
    assert _rel_err(got[0], ref[0]) > CARD_TOL
