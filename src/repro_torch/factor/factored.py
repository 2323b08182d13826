"""FactoredTensor: shared dense basis + small per-expert delta, the port of
``repro.factor.factored``.

Per-expert weights are small perturbations of a common function, so a bank
of E expert weights ``W_e (K, N)`` decomposes as ``W_e ≈ B + Δ_e``: the
**basis** ``B (K, N)`` is shared by every expert (on the device once, never
paged) and the per-expert **delta** ``Δ_e`` is small:

  * ``kind="rank"``      — ``Δ_e = U_e @ V_e`` with ``U_e (K, r)``,
    ``V_e (r, N)``, seeded by the truncated SVD of the residual
    ``W_e − B``.
  * ``kind="butterfly"`` — a Monarch-style product of two block-diagonal
    factors: with ``K = K1·K2`` and ``N = N1·N2``,
    ``Δ_e[(k1,k2),(n1,n2)] = L_e[k1,k2,n2] · R_e[n2,k1,n1]``, seeded by the
    rank-1 SVD of each ``(k1, n2)`` slice of the residual.

``delta_bits=8/4`` stores the factors as nested :class:`QTensor` objects.
The SVD seeding is the reference's host NumPy, copied, so the same weights
give the same basis, ``u`` and ``v`` bits.

The compute forms (:func:`factored_moe_gemm`, :func:`factored_linear`)
back the ``eager_factored`` impls.  They keep the reference's order of
operations — the basis product, an int8 ``u`` as a per-channel epilogue,
``v`` dequantized before its product, then ``+ delta`` — and take every
expert's products one expert at a time, ``(rows, K) × (K, N)`` with rows
= the routing groups' queue rows.  A product's shape then never depends on
how many experts share the call, so the library picks the same algorithm
for an expert whether it runs among all E experts or among the R slots of
a paged wave, and paged output equals the all-resident output bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.quant.qtensor import (_walk, dequantize, dtype_name,
                                       is_qtensor, leaf_name, quantize,
                                       torch_dtype)

__all__ = [
    "FactoredTensor", "is_factored", "factorize", "reconstruct",
    "factorize_tree", "reconstruct_tree", "factored_linear",
    "factored_moe_gemm", "per_expert_products", "FACTOR_PARAM_NAMES",
    "split_dim",
]

_KINDS = ("rank", "butterfly")


class FactoredTensor:
    """Shared basis + per-expert delta factors as one parameter leaf.

    ``basis`` (K, N) is the dense shared weight (float32); ``u``/``v`` are
    the delta factors — per expert (leading E axis) or single (no E axis):

      * ``kind="rank"``:      ``u (E?, K, r)``, ``v (E?, r, N)``
      * ``kind="butterfly"``: ``u (E?, K1, K2, N2)``, ``v (E?, N2, K1, N1)``

    ``u``/``v`` may be :class:`QTensor` objects (int8/int4 deltas);
    ``dtype`` is the logical compute dtype's name.
    """

    __slots__ = ("basis", "u", "v", "kind", "dtype")

    def __init__(self, basis, u, v, *, kind: str = "rank",
                 dtype="float32"):
        self.basis = basis
        self.u = u
        self.v = v
        self.kind = str(kind)
        self.dtype = dtype_name(dtype)

    @property
    def experts(self) -> Optional[int]:
        """Expert count (leading delta axis), or None for a single weight."""
        per_expert_ndim = 2 if self.kind == "rank" else 3
        u_shape = tuple(self.u.shape)   # QTensor.shape is the logical shape
        return int(u_shape[0]) if len(u_shape) == per_expert_ndim + 1 \
            else None

    @property
    def rank(self) -> int:
        """Delta rank (``kind="rank"`` only; 0 = pure basis)."""
        return int(tuple(self.u.shape)[-1]) if self.kind == "rank" else -1

    @property
    def shape(self) -> tuple:
        """Logical (reconstructed) shape: (E, K, N) or (K, N)."""
        kn = tuple(self.basis.shape)
        e = self.experts
        return ((e,) + kn) if e is not None else kn

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def basis_nbytes(self) -> int:
        """Bytes resident once whatever the expert count (never paged)."""
        return int(self.basis.nbytes)

    @property
    def delta_nbytes(self) -> int:
        """Bytes that scale with E — the unit the expert cache pages."""
        return int(self.u.nbytes) + int(self.v.nbytes)

    @property
    def nbytes(self) -> int:
        return self.basis_nbytes + self.delta_nbytes

    def to(self, device) -> "FactoredTensor":
        """Basis and deltas on ``device``."""
        return FactoredTensor(self.basis.to(device), self.u.to(device),
                              self.v.to(device), kind=self.kind,
                              dtype=self.dtype)

    def __repr__(self) -> str:
        return (f"FactoredTensor({self.kind}, shape={self.shape}, "
                f"dtype={self.dtype}, basis={self.basis_nbytes}B, "
                f"delta={self.delta_nbytes}B)")


def is_factored(x: Any) -> bool:
    return isinstance(x, FactoredTensor)


# ------------------------------------------------------------------ helpers


def split_dim(n: int) -> tuple[int, int]:
    """Butterfly block split: the most-square factorization ``n = a·b``
    with ``a <= b`` (a = largest divisor <= sqrt(n); a = 1 for primes)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"cannot split non-positive dim {n}")
    a = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            a = d
            break
    return a, n // a


def _host_f32(w) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as float32 NumPy."""
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def _check_finite(arr: np.ndarray, what: str) -> None:
    if not np.isfinite(arr).all():
        raise ValueError(
            f"factorize: {what} contains NaN/Inf — a non-finite value "
            "poisons the SVD seeding (every singular vector goes NaN) and "
            "would silently zero the reconstruction; clean the weights "
            "first")


def _leaf_f(leaf, acc):
    """Delta factor -> floating tensor in ``acc`` (dequantizes a
    QTensor)."""
    return dequantize(leaf, acc) if is_qtensor(leaf) else leaf.to(acc)


def _quantize_delta(leaf: torch.Tensor, bits: int):
    """Quantize one delta factor; a zero-size factor (rank 0) stays raw."""
    if leaf.numel() == 0:
        return leaf
    return quantize(leaf, bits)


# ---------------------------------------------------------------- factorize


def _factorize_rank(resid: np.ndarray, rank: int):
    """Truncated SVD of each expert's residual ``(E, K, N)`` ->
    ``u (E, K, r)``, ``v (E, r, N)``, the singular values split evenly."""
    e, k, n = resid.shape
    r = max(0, min(int(rank), k, n))
    if r == 0:
        return (np.zeros((e, k, 0), np.float32),
                np.zeros((e, 0, n), np.float32))
    uu, ss, vt = np.linalg.svd(resid.astype(np.float64),
                               full_matrices=False)
    sq = np.sqrt(ss[:, :r])
    u = (uu[:, :, :r] * sq[:, None, :]).astype(np.float32)
    v = (sq[:, :, None] * vt[:, :r, :]).astype(np.float32)
    return u, v


def _factorize_butterfly(resid: np.ndarray):
    """Monarch projection of each expert's residual: every ``(k1, n2)``
    slice of ``(E, K1, K2, N1, N2)`` is a ``(K2, N1)`` matrix whose best
    rank-1 factor is its leading SVD component."""
    e, k, n = resid.shape
    k1, k2 = split_dim(k)
    n1, n2 = split_dim(n)
    m = resid.astype(np.float64).reshape(e, k1, k2, n1, n2)
    m = m.transpose(0, 1, 4, 2, 3)                   # (E, K1, N2, K2, N1)
    uu, ss, vt = np.linalg.svd(m, full_matrices=False)
    s0 = np.sqrt(ss[..., 0])                           # (E, K1, N2)
    left = uu[..., :, 0] * s0[..., None]               # (E, K1, N2, K2)
    right = s0[..., None] * vt[..., 0, :]              # (E, K1, N2, N1)
    l_fac = left.transpose(0, 1, 3, 2).astype(np.float32)   # (E,K1,K2,N2)
    r_fac = right.transpose(0, 2, 1, 3).astype(np.float32)  # (E,N2,K1,N1)
    return l_fac, r_fac


def factorize(w, kind: str = "rank", *, rank: int = 8, basis=None,
              delta_bits: Optional[int] = None,
              dtype=None) -> FactoredTensor:
    """Offline converter: dense (or QTensor) expert weights -> shared basis
    + SVD-seeded per-expert delta, on ``w``'s device.

    ``w``: ``(E, K, N)`` stacked expert weights, or a single ``(K, N)``
    weight with an explicit ``basis``.  ``basis`` defaults to the mean over
    experts.  ``rank``: delta rank for ``kind="rank"`` (ignored for
    butterfly).  ``delta_bits``: 8/4 stores the delta factors as QTensors.
    Rejects non-finite inputs.
    """
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if int(rank) < 0:
        raise ValueError(f"rank must be >= 0, got {rank}")
    if is_qtensor(w):
        w = dequantize(w)
    if getattr(w, "ndim", 0) not in (2, 3):
        raise ValueError(f"factorize expects (E, K, N) stacked experts or "
                         f"a (K, N) weight, got shape "
                         f"{tuple(getattr(w, 'shape', ()))}")
    device = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    wf = _host_f32(w)
    _check_finite(wf, "weights")
    ldtype = dtype_name(dtype) if dtype is not None else dtype_name(
        w.dtype if isinstance(w, torch.Tensor) else wf.dtype)
    single = wf.ndim == 2
    if single:
        wf = wf[None]
    if basis is None:
        if single:
            raise ValueError("factorize of a single (K, N) weight needs an "
                             "explicit basis to delta against")
        b = wf.mean(axis=0)
    else:
        if is_qtensor(basis):
            basis = dequantize(basis)
        b = _host_f32(basis)
        _check_finite(b, "basis")
        if b.shape != wf.shape[1:]:
            raise ValueError(f"basis shape {b.shape} != weight shape "
                             f"{wf.shape[1:]}")
    resid = wf - b[None]
    if kind == "rank":
        u, v = _factorize_rank(resid, rank)
    else:
        u, v = _factorize_butterfly(resid)
    if single:
        u, v = u[0], v[0]
    u = torch.from_numpy(np.ascontiguousarray(u)).to(device)
    v = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    if delta_bits is not None:
        if delta_bits not in (8, 4):
            raise ValueError(f"delta_bits must be 8 or 4, got {delta_bits}")
        u = _quantize_delta(u, delta_bits)
        v = _quantize_delta(v, delta_bits)
    b_t = torch.from_numpy(np.ascontiguousarray(b)).to(device)
    return FactoredTensor(b_t, u, v, kind=kind, dtype=ldtype)


# -------------------------------------------------------------- reconstruct


def _monarch_dense(l_fac, r_fac):
    """(E?, K1, K2, N2) x (E?, N2, K1, N1) -> dense (E?, K, N):
    ``W[(k1,k2),(n1,n2)] = L[k1,k2,n2] * R[n2,k1,n1]``."""
    d = torch.einsum("...akn,...nab->...akbn", l_fac, r_fac)
    k = d.shape[-4] * d.shape[-3]
    n = d.shape[-2] * d.shape[-1]
    return d.reshape(d.shape[:-4] + (k, n))


def reconstruct(ft: FactoredTensor, dtype=None) -> torch.Tensor:
    """FactoredTensor -> dense ``(E, K, N)`` (or ``(K, N)``) in ``dtype``
    (default: the logical dtype)."""
    acc = torch.float32
    b = ft.basis.to(acc)
    u, v = _leaf_f(ft.u, acc), _leaf_f(ft.v, acc)
    if ft.kind == "rank":
        delta = torch.einsum("...kr,...rn->...kn", u, v)
    else:
        delta = _monarch_dense(u, v)
    if ft.experts is not None:
        b = b[None]
    return (b + delta).to(torch_dtype(dtype if dtype is not None
                                      else ft.dtype))


# ------------------------------------------------------------ apply helpers


def per_expert_products(x: torch.Tensor, fn) -> torch.Tensor:
    """x (..., E, C, K) -> (..., E, C, N): ``fn(e, rows)`` on each expert's
    queue rows of every leading group, ``rows`` (prod(...)·C, K), one call
    per expert — so no product's shape depends on E."""
    xe = x.movedim(-3, 0)                         # (E, ..., C, K)
    lead = tuple(xe.shape[1:-1])
    outs = [fn(e, xe[e].reshape(-1, xe.shape[-1])) for e in
            range(xe.shape[0])]
    return torch.stack([o.reshape(lead + (o.shape[-1],)) for o in outs],
                       dim=-3)


def _rank_rows(rows, u, v, acc, e=None):
    """The rank delta on ``rows`` (M, K): ``(rows @ u) @ v``, an int8 ``u``
    as the per-channel epilogue, ``v`` dequantized before its product
    (the reference's order)."""
    def pick(t):
        return t if e is None else t[e]
    if is_qtensor(u) and u.bits == 8:
        t = torch.matmul(rows, pick(u.q).to(acc)) * pick(u.scale).to(acc)
    else:
        t = torch.matmul(rows, pick(_leaf_f(u, acc)))
    return torch.matmul(t, pick(_leaf_f(v, acc)))


def _butterfly_rows(rows, l_fac, r_fac):
    """The Monarch delta on ``rows`` (..., K) with factors (K1, K2, N2) and
    (N2, K1, N1), never materialized."""
    k1, k2, _ = l_fac.shape
    xr = rows.reshape(rows.shape[:-1] + (k1, k2))
    t = torch.einsum("...ak,akn->...an", xr, l_fac)
    z = torch.einsum("...an,nab->...bn", t, r_fac)
    return z.reshape(z.shape[:-2] + (-1,))


def factored_moe_gemm(buf, ft: FactoredTensor, acc) -> torch.Tensor:
    """(..., E, C, K) x factored (E, K, N) -> (..., E, C, N) in ``acc``.

    Per expert: the basis product, then ``+`` the delta correction (two
    skinny products).  The deltas are dequantized once for the call (an
    int8 rank ``u`` keeps its per-channel epilogue)."""
    xb = buf.to(acc)
    basis = ft.basis.to(acc)
    if ft.kind == "rank":
        if ft.rank == 0:
            return per_expert_products(xb, lambda e, r: r @ basis)
        u = ft.u if is_qtensor(ft.u) and ft.u.bits == 8 \
            else _leaf_f(ft.u, acc)
        v = _leaf_f(ft.v, acc)
        return per_expert_products(
            xb, lambda e, r: r @ basis + _rank_rows(r, u, v, acc, e))
    l_fac, r_fac = _leaf_f(ft.u, acc), _leaf_f(ft.v, acc)
    return per_expert_products(
        xb, lambda e, r: r @ basis + _butterfly_rows(r, l_fac[e], r_fac[e]))


def factored_linear(x, ft: FactoredTensor, acc) -> torch.Tensor:
    """(..., K) x factored single (K, N) -> (..., N) in ``acc``."""
    xb = x.to(acc)
    y = torch.matmul(xb, ft.basis.to(acc))
    if ft.kind == "rank":
        if ft.rank == 0:
            return y
        return y + _rank_rows(xb, ft.u, ft.v, acc)
    return y + _butterfly_rows(xb, _leaf_f(ft.u, acc), _leaf_f(ft.v, acc))


# -------------------------------------------------------------------- trees

# Per-expert stacked (leading E axis, ndim == 3) FFN weights — the set the
# serving layer pages and therefore the set worth factoring.  Gates and
# biases are absent: gates route, and biases are O(d).
FACTOR_PARAM_NAMES = frozenset({"wg", "wu", "wd", "w1", "w2"})


def _factorable(name: str, leaf, names) -> bool:
    if name not in names or is_factored(leaf):
        return False
    if is_qtensor(leaf):
        return len(leaf.shape) == 3
    return (isinstance(leaf, torch.Tensor) and leaf.dim() == 3
            and leaf.is_floating_point())


def _gate_sibling(node: dict, key) -> bool:
    """Whether ``key`` sits next to a ``gate``: in a nested dict the key
    ``gate``, in a flat dotted-name dict ``<prefix>.gate``."""
    key = str(key)
    if "." in key:
        return f"{key.rsplit('.', 1)[0]}.gate" in node
    return "gate" in node


def factorize_tree(tree, kind: str = "rank", *, rank: int = 8,
                   delta_bits: Optional[int] = None,
                   names=FACTOR_PARAM_NAMES):
    """Offline converter: replace every stacked-expert weight leaf (name in
    ``names``, ndim == 3, floating or QTensor, next to a ``gate`` sibling)
    with a :class:`FactoredTensor`.  The gate sibling marks an expert dict:
    a layer-stacked dense weight of the same name and rank is never
    averaged into a basis.  Everything else passes through untouched.
    Takes the flat dotted-name dict or nested dicts."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(v, (dict, list, tuple)):
                    out[k] = walk(v)
                elif _gate_sibling(node, k) and _factorable(
                        leaf_name(k), v, names):
                    out[k] = factorize(v, kind, rank=rank,
                                       delta_bits=delta_bits)
                else:
                    out[k] = v
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node
    return walk(tree)


def reconstruct_tree(tree):
    """Inverse of :func:`factorize_tree` (lossy: the reconstructed dense
    weights in their logical dtype)."""
    return _walk(tree, lambda _, v: reconstruct(v) if is_factored(v) else v)
