"""The numerics of the packed attention kernels' f32 forms, emulated on the CPU.

On the card the f32 products run on the tensor cores as three TF32 products:
each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
a . b = lo_a . hi_b + hi_a . lo_b + hi_a . hi_b (csrc/short_attention_common.cuh).
Here TF32 rounding is done with integer bit operations on float32 (10
mantissa bits kept; to nearest with ties away from zero, as cvt.rna.tf32.f32
rounds, or by truncation, as CUTLASS takes hi), the products of TF32 values
are exact, and the packed forward and backward are computed in the kernels'
order at the ViT's T=197, D=64 with the qkv bias and q's scaling, then held
against the plain versions: three terms stay ten times inside the card's f32
tolerance of 2e-4 (of max |ref|), one term alone does not meet it on the
backward. Imports torch and the port only.
"""
import math

import numpy as np
import pytest
import torch

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


def split_product(hi_rounding="rna", terms=3):
    """a @ b as the kernels form it: three TF32 terms (lo.hi + hi.lo +
    hi.hi), or with terms=1 one TF32 product; lo is always rounded by rna."""
    def mm(a, b):
        a_hi, b_hi = tf32(a, hi_rounding), tf32(b, hi_rounding)
        out = a_hi.double() @ b_hi.double()
        if terms == 3:
            a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
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
