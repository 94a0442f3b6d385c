"""Bytes and operations of the flash attention at two head widths (the
latent attention of the Moonlight-16B-A3B head: q and k DQ wide, v DV wide)
at one call's shapes: B sequences of T queries over T keys, H heads; the
(query, key) pairs a causal mask keeps, each input read once and each
output written once.

Forward: q, k (DQ), v (DV) in, out (DV) and the f32 log-sum-exp out; QK^T
over DQ and PV over DV, 2 B H pairs (DQ + DV). Backward: q, k, v, dout, lse
and delta in, dq, dk (DQ), dv (DV) out; S and dQ, dK over DQ, dP and dV
over DV: 2 B H pairs (2 DQ + DV + DQ + DV), which is work/flash_attention.py's
10 B H pairs D at DQ = DV = D.
"""
from __future__ import annotations

from portbench.work.flash_attention import pairs


def forward_work(B: int, T: int, H: int, DQ: int, DV: int, itemsize: int, causal: bool):
    nbytes = B * T * H * (2 * DQ + 2 * DV) * itemsize + B * H * T * 4
    return nbytes, 2 * B * H * pairs(T, causal) * (DQ + DV)


def backward_work(B: int, T: int, H: int, DQ: int, DV: int, itemsize: int, causal: bool):
    rows_in = B * T * H * (2 * DQ + 2 * DV)  # q, k, v, dout
    rows_out = B * T * H * (2 * DQ + DV)  # dq, dk, dv
    nbytes = (rows_in + rows_out) * itemsize + 2 * B * H * T * 4
    return nbytes, 2 * B * H * pairs(T, causal) * (2 * DQ + DV + DQ + DV)
