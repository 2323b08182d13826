"""QTensor: packed low-precision weights + scales as one parameter leaf,
the port of ``repro.quant.qtensor``.

Edge-MoE's memory story is experts-per-byte: the expert stream (§IV-D)
moves whole expert weight tensors, so shrinking the bytes per expert
multiplies both the resident-expert count at a fixed device budget and the
effective paging bandwidth.  Two formats:

  * **int8, per-channel** — symmetric quantization along the contraction
    axis (axis ``-2`` of a ``(..., K, N)`` weight): one float32 scale per
    output channel, ``w ≈ q * scale``.  The scale is constant along K, so
    dequantization commutes with the GEMM and becomes a per-column
    epilogue: ``x @ w ≈ (x @ q) * scale`` — the form the ``eager_int8``
    impls use.
  * **int4, grouped** — symmetric ±7 quantization with one scale per
    ``group_size`` rows of K per output channel, two values packed per
    ``uint8`` byte along K (unsigned, so ``>> 4`` is a logical shift).  The
    scale varies along K, so int4 dequantizes before the GEMM.

The arithmetic is the reference's step for step (amax along the axis,
``max(amax / qmax, tiny)``, round half to even, clip, cast), so the same
float32 weights give the same ``q`` and ``scale`` bits.  The port's
parameter trees are flat dotted names (``repro_torch.tree``): a packed
leaf is one :class:`QTensor` object at its name, and indexing its leading
axis (``qt[i]``, what ``tree.index`` does to a stacked layer) slices
``q`` and ``scale`` together.

:func:`quantize_kv` is the KV-cache variant: per (token, head) — one scale
per written cache row — with no host checks, since it runs inside the
decode step.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "QTensor", "is_qtensor", "quantize", "dequantize", "quantize_kv",
    "quantize_tree", "dequantize_tree", "tree_bytes", "QUANT_PARAM_NAMES",
    "dtype_name", "torch_dtype",
]

_TINY = float(np.finfo(np.float32).tiny)


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` / ``"bfloat16"`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(dtype) -> torch.dtype:
    """A dtype name (the reference's logical dtype string) or a torch dtype
    -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, dtype_name(dtype), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


class QTensor:
    """Packed values + scales.  ``q``/``scale`` are tensors; ``bits``
    (8 | 4), ``dtype`` (the logical compute dtype, a name such as
    ``"bfloat16"``) and ``rows`` (the logical size of the contraction
    axis; None for int8, where it equals ``q.shape[-2]``) describe them.
    """

    __slots__ = ("q", "scale", "bits", "dtype", "rows")

    def __init__(self, q, scale, *, bits: int = 8, dtype="float32",
                 rows: Optional[int] = None):
        self.q = q
        self.scale = scale
        self.bits = int(bits)
        self.dtype = dtype_name(dtype)
        self.rows = None if rows is None else int(rows)

    @property
    def shape(self) -> tuple:
        """Logical (dequantized) shape."""
        s = tuple(self.q.shape)
        if self.bits == 4:
            rows = self.rows if self.rows is not None else 2 * s[-2]
            return s[:-2] + (rows,) + s[-1:]
        return s

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.scale.nbytes)

    def to(self, device) -> "QTensor":
        """Both tensors on ``device``."""
        return QTensor(self.q.to(device), self.scale.to(device),
                       bits=self.bits, dtype=self.dtype, rows=self.rows)

    def __getitem__(self, i) -> "QTensor":
        """Slice a leading (stacked-layer or expert) axis of ``q`` and
        ``scale`` together."""
        if self.q.dim() <= 2:
            raise IndexError("a QTensor indexes its leading axes only; "
                             f"this one has shape {self.shape}")
        return QTensor(self.q[i], self.scale[i], bits=self.bits,
                       dtype=self.dtype, rows=self.rows)

    def __repr__(self) -> str:
        return (f"QTensor(int{self.bits}, shape={self.shape}, "
                f"dtype={self.dtype}, nbytes={self.nbytes})")


def is_qtensor(x: Any) -> bool:
    return isinstance(x, QTensor)


# ---------------------------------------------------------------- quantize


def _as_tensor(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.as_tensor(
        np.asarray(w))


def _check_finite(w: torch.Tensor) -> None:
    if not bool(torch.isfinite(w.float()).all()):
        raise ValueError(
            "quantize: input contains NaN/Inf — a non-finite value would "
            "poison the channel scale (amax) and silently zero the whole "
            "channel; clean the weights first")


def _quantize_int8(w: torch.Tensor, dtype: str) -> QTensor:
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, _TINY)      # scale > 0 always
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale, bits=8, dtype=dtype)


def _quantize_int4(w: torch.Tensor, group_size: int, dtype: str) -> QTensor:
    rows = w.shape[-2]
    g = max(2, min(int(group_size), rows))
    g += g % 2                                     # even: packing pairs rows
    pad = (-rows) % g
    wf = w.float()
    if pad:
        wf = torch.nn.functional.pad(wf, (0, 0, 0, pad))
    kp = rows + pad
    lead = tuple(wf.shape[:-2])
    n = wf.shape[-1]
    grouped = wf.reshape(lead + (kp // g, g, n))
    amax = grouped.abs().amax(dim=-2)              # (..., K/g, N)
    scale = torch.clamp_min(amax / 7.0, _TINY)
    q = torch.round(grouped / scale[..., None, :]).clamp(-7, 7)
    q = q.reshape(lead + (kp, n)).to(torch.int8)
    lo = (q[..., 0::2, :] & 0xF).to(torch.uint8)
    hi = (q[..., 1::2, :] & 0xF).to(torch.uint8)
    return QTensor(lo | (hi << 4), scale, bits=4, dtype=dtype, rows=rows)


def quantize(w, bits: int = 8, *, group_size: int = 32,
             dtype=None) -> QTensor:
    """Quantize a weight ``(..., K, N)`` along the contraction axis.

    ``bits=8``: per-channel symmetric int8, scale ``(..., 1, N)``.
    ``bits=4``: grouped symmetric int4 (±7), ``group_size`` rows per scale,
    packed two values per byte along K.  The packed tensors lie on ``w``'s
    device.  Rejects non-finite inputs (an offline converter; use
    :func:`quantize_kv` inside a step).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if getattr(w, "ndim", 0) < 2:
        raise ValueError(f"quantize expects a (..., K, N) weight, "
                         f"got shape {tuple(getattr(w, 'shape', ()))}")
    w = _as_tensor(w)
    _check_finite(w)
    ldtype = dtype_name(dtype) if dtype is not None else dtype_name(w.dtype)
    if bits == 8:
        return _quantize_int8(w, ldtype)
    return _quantize_int4(w, group_size, ldtype)


def dequantize(qt: QTensor, dtype=None) -> torch.Tensor:
    """QTensor -> dense tensor in ``dtype`` (default: the logical dtype)."""
    if qt.bits == 8:
        w = qt.q.float() * qt.scale
    else:
        packed = qt.q
        lo = (packed & 0xF).to(torch.int8)
        hi = (packed >> 4).to(torch.int8)
        lo = torch.where(lo >= 8, lo - 16, lo)     # sign-extend the nibble
        hi = torch.where(hi >= 8, hi - 16, hi)
        lead = tuple(packed.shape[:-2])
        n = packed.shape[-1]
        kp = 2 * packed.shape[-2]
        q = torch.stack([lo, hi], dim=-2)          # (..., K/2, 2, N)
        q = q.reshape(lead + (kp, n)).float()
        ng = qt.scale.shape[-2]
        g = kp // ng
        w = (q.reshape(lead + (ng, g, n))
             * qt.scale[..., :, None, :]).reshape(lead + (kp, n))
        rows = qt.rows if qt.rows is not None else kp
        if rows != kp:
            w = w[..., :rows, :]
    return w.to(torch_dtype(dtype if dtype is not None else qt.dtype))


# ------------------------------------------------------------------ KV cache


def quantize_kv(x: torch.Tensor):
    """Per-row (token × head) symmetric int8: ``(..., D)`` ->
    ``(q int8 (..., D), scale float32 (..., 1))``, with no host check; an
    all-zero row keeps a tiny positive scale and dequantizes to exact
    zeros."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, _TINY)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


# -------------------------------------------------------------------- trees

# Weight names that flow through the ``linear`` / ``moe_grouped_gemm``
# dispatch (attention projections, MLPs, MoE experts + shared experts, LM /
# task heads, patch embed, recurrent up/down projections).  Gates, biases,
# norms, embeddings and convs are absent: they are consumed by raw products
# and lookups, or too small to matter.
QUANT_PARAM_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w", "wg", "wu", "wd", "w1", "w2",
    "shared_wg", "shared_wu", "shared_wd", "w_up", "w_up2", "w_down",
    "w_qkv",
})


def leaf_name(key) -> str:
    """The last component of a dotted name (``layers.b1.moe.w1`` -> ``w1``);
    a nested tree's key is its own last component."""
    return str(key).rsplit(".", 1)[-1]


def _quantizable(name: str, leaf, names) -> bool:
    # packed objects (QTensor, FactoredTensor) are not tensors and pass
    # through untouched: a factored leaf's deltas are quantized when it is
    # factorized, never re-wrapped
    return (name in names and isinstance(leaf, torch.Tensor)
            and leaf.dim() >= 2 and leaf.is_floating_point())


def _walk(node, leaf_fn):
    """Map ``leaf_fn(key, leaf)`` over the leaves of nested dicts, lists
    and tuples (a flat dotted-name dict is one level)."""
    if isinstance(node, dict):
        return {k: (_walk(v, leaf_fn) if isinstance(v, (dict, list, tuple))
                    else leaf_fn(k, v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, leaf_fn) for v in node]
    if isinstance(node, tuple):
        return tuple(_walk(v, leaf_fn) for v in node)
    return leaf_fn(None, node)


def quantize_tree(tree, bits: int = 8, *, group_size: int = 32,
                  names=QUANT_PARAM_NAMES):
    """Offline converter: replace every matmul-weight leaf (whose name's
    last component is in ``names``, ndim >= 2, floating) with a
    :class:`QTensor`.  Everything else — gates, biases, norms, embeddings,
    leaves already packed — passes through untouched.  Takes the flat
    dotted-name dict or nested dicts."""
    def leaf(key, v):
        if key is not None and _quantizable(leaf_name(key), v, names):
            return quantize(v, bits, group_size=group_size)
        return v
    return _walk(tree, leaf)


def dequantize_tree(tree):
    """Inverse of :func:`quantize_tree` (lossy: the dequantized weights in
    their logical dtype)."""
    return _walk(tree, lambda _, v: dequantize(v) if is_qtensor(v) else v)


def tree_bytes(tree) -> int:
    """Total storage bytes of a parameter tree (packed leaves count their
    packed tensors)."""
    total = [0]

    def leaf(_, v):
        total[0] += int(v.nbytes)
        return v
    _walk(tree, leaf)
    return total[0]
