"""The order of work of the two attention kernels on the card, modelled in
float32 PyTorch on the CPU and held against the Pallas kernels in
interpret mode on the same NumPy inputs, under ``kernels/compare.py``'s
tolerance (bf16: one bf16 ulp of the output plus ``1e-5 + 1e-5·|ref|``).

* ``flash_attention`` (``tc``): K/V tiles of 64 keys; S from the bf16
  operands (products exact in float32) with the scale (times log2 e, for
  exp2) applied to the float32 S afterwards; masked scores −1e30 with
  probability 0; the online max and sum per tile with α rescaling the
  float32 accumulator; P·V with P split into a bf16 pair ``hi = bf16(P)``,
  ``lo = bf16(P − hi)``, each tile's product added as ``acc·α + pv``.  The same model with a single
  bf16 P leaves the tolerance at M³ViT's shape: that is why the kernel
  multiplies the pair.
* ``decode_fused``: the Smax slots in splits of 64 keys (tiles of 32), each
  split's float32 (m, l, acc) partial with empty splits at (−1e30, 0, 0),
  merged in ascending split order; q scaled in its own dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jk
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import attn_plan
from repro_torch.kernels.compare import kernel_tolerance, within_tolerance

NEG = -1e30
BF16 = torch.bfloat16


def _bf16_pair(rng, shape):
    """bf16 values as a JAX array and a CPU tensor."""
    a = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    return a, tensor_from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)


def _to_torch(j):
    return tensor_from_numpy(np.asarray(j.astype(jnp.float32)))


def _visible(qpos, kpos, causal, window, skv):
    ok = (kpos < skv)[None, :].expand(qpos.shape[0], -1)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def tc_model(q, k, v, *, causal, window=None, q_offset=0, pair=True):
    """The ``tc`` kernel's arithmetic: q (B, Hq, Sq, D), k/v (B, Hkv, Skv,
    D) bf16 -> (B, Hq, Sq, D) bf16."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale2 = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) \
        * torch.tensor(np.log2(np.e), dtype=torch.float32)
    group = hq // hkv
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    qpos = torch.arange(sq) + q_offset
    m = torch.full((b, hq, sq, 1), NEG)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    tile = attn_plan.TC_KEYS
    for k0 in range(0, skv, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale2
        ok = _visible(qpos, torch.arange(k0, k0 + kt.shape[2]), causal,
                      window, skv)
        s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(BF16).float()
        if pair:
            lo = (p - hi).to(BF16).float()
            pv = torch.matmul(hi, vt) + torch.matmul(lo, vt)
        else:
            pv = torch.matmul(hi, vt)
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-37)).to(BF16)


def decode_model(q, k, v, lengths, *, window=None):
    """The split ``decode_fused`` kernel's arithmetic: q (B, Hq, 1, D),
    caches (B, Hkv, Smax, D) -> (B, Hq, 1, D) in q's dtype."""
    b, hq, _, d = q.shape
    hkv, smax = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=q.dtype)
    qs = (q * scale).float().reshape(b, hkv, group, d)
    out = torch.zeros((b, hkv, group, d))
    for bi in range(b):
        cl = min(max(int(lengths[bi]), 0), smax)
        frontier = cl - 1 - (window if window is not None else 0)
        parts = []
        for lo, hi in attn_plan.split_ranges(smax):
            hi = min(hi, cl)
            m = torch.full((hkv, group, 1), NEG)
            l = torch.zeros((hkv, group, 1))
            acc = torch.zeros((hkv, group, d))
            live = lo < hi and not (window is not None and hi - 1 <= frontier)
            for t0 in range(lo, hi, attn_plan.DECODE_TILE) if live else ():
                keys = torch.arange(t0, t0 + attn_plan.DECODE_TILE)
                kt = k[bi, :, t0:t0 + attn_plan.DECODE_TILE].float()
                vt = v[bi, :, t0:t0 + attn_plan.DECODE_TILE].float()
                pad = attn_plan.DECODE_TILE - kt.shape[1]
                kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
                vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
                ok = keys < hi
                if window is not None:
                    ok = ok & (keys > frontier)
                s = torch.where(ok, torch.einsum("hgd,hkd->hgk", qs[bi], kt),
                                NEG)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(s - m_new), 0.0)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum("hgk,hkd->hgd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([p[0] for p in parts]).amax(0)
        lsum = torch.zeros_like(mx)
        total = torch.zeros((hkv, group, d))
        for m, l, acc in parts:          # ascending split order
            w = torch.exp(m - mx)
            lsum = lsum + l * w
            total = total + acc * w
        out[bi] = total / torch.clamp_min(lsum, 1e-37)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _outside(got, want):
    tol = kernel_tolerance(got, want, BF16)
    return float(((got.float() - want.float()).abs() > tol).float().mean())


# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset)
FLASH_CASES = {
    "m3vit": (2, 3, 3, 128, 128, 64, False, None, 0),
    "lm_prefill": (1, 8, 2, 128, 512, 64, True, None, 0),
    "d48_window_offset": (1, 6, 2, 77, 100, 48, True, 24, 23),
    "sq1_live_prefix": (2, 8, 2, 1, 150, 64, True, None, 149),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_tc_model_matches_pallas(rng, case):
    b, hq, hkv, sq, skv, d, causal, window, q_offset = FLASH_CASES[case]
    qj, qt = _bf16_pair(rng, (b, hq, sq, d))
    kj, kt = _bf16_pair(rng, (b, hkv, skv, d))
    vj, vt = _bf16_pair(rng, (b, hkv, skv, d))
    want = _to_torch(jk.flash_attention(qj, kj, vj, causal=causal,
                                        window=window, q_offset=q_offset,
                                        interpret=True))
    got = tc_model(qt, kt, vt, causal=causal, window=window,
                   q_offset=q_offset)
    assert within_tolerance(got, want, BF16), \
        f"{_outside(got, want):.2%} of outputs outside the bf16 tolerance"


def test_flash_single_bf16_p_leaves_the_tolerance(rng):
    """At M³ViT's shape a P rounded once to bf16 before P·V puts a share
    of the outputs outside the tolerance that the hi/lo pair keeps."""
    b, hq, _, sq, skv, d, causal, _, _ = FLASH_CASES["m3vit"]
    qj, qt = _bf16_pair(rng, (b, hq, sq, d))
    kj, kt = _bf16_pair(rng, (b, hq, skv, d))
    vj, vt = _bf16_pair(rng, (b, hq, skv, d))
    want = _to_torch(jk.flash_attention(qj, kj, vj, causal=causal,
                                        interpret=True))
    single = _outside(tc_model(qt, kt, vt, causal=causal, pair=False), want)
    assert single > 0.02, single
    assert _outside(tc_model(qt, kt, vt, causal=causal), want) == 0.0


def test_flash_tc_model_fully_masked_rows_are_zero(rng):
    _, qt = _bf16_pair(rng, (1, 2, 8, 16))
    _, kt = _bf16_pair(rng, (1, 2, 20, 16))
    out = tc_model(qt, kt, kt, causal=True, window=2, q_offset=-4)
    assert (out[0, :, :4].float().numpy().view(np.uint32) == 0).all()
    assert (out[0, :, 4:] != 0).any()


# lengths 0, 1, on a split boundary and around it, Smax
DECODE_LENGTHS = [0, 1, 63, 64, 65, 129, 150]


@pytest.mark.parametrize("window", [None, 5, 70], ids=["full", "window5",
                                                        "window70"])
def test_decode_split_model_matches_pallas(rng, window):
    b, hq, hkv, smax, d = len(DECODE_LENGTHS), 8, 2, 150, 64
    qj, qt = _bf16_pair(rng, (b, hq, 1, d))
    kj, kt = _bf16_pair(rng, (b, hkv, smax, d))
    vj, vt = _bf16_pair(rng, (b, hkv, smax, d))
    want = _to_torch(jk.fused_decode_attention(
        qj, kj, vj, jnp.asarray(DECODE_LENGTHS, jnp.int32), window=window,
        interpret=True))
    got = decode_model(qt, kt, vt, DECODE_LENGTHS, window=window)
    assert within_tolerance(got, want, BF16), \
        f"{_outside(got, want):.2%} of outputs outside the bf16 tolerance"
    assert (got[0].float().numpy().view(np.uint32) == 0).all()


def test_decode_split_model_float32_matches_pallas(rng):
    lengths = [0, 64, 65, 70]
    q = rng.normal(size=(4, 6, 1, 128)).astype(np.float32)
    k = rng.normal(size=(4, 2, 70, 128)).astype(np.float32)
    v = rng.normal(size=(4, 2, 70, 128)).astype(np.float32)
    want = tensor_from_numpy(np.asarray(jk.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths, jnp.int32), window=5, interpret=True)))
    got = decode_model(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), lengths, window=5)
    assert within_tolerance(got, want, torch.float32)
