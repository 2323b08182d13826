"""Chunked int8 gradient compression with error feedback, the port of
``repro.dist.compress``, term for term.

Gradients are split into ``CHUNK``-sized chunks, each chunk carrying one
float32 scale (``amax / 127``) and int8 mantissas, so the payload is
about 4× smaller.  The quantization error is kept in a per-rank
*error-feedback* state added back into the next step's gradient, which
makes the compression unbiased over time (EF-SGD reaches the
uncompressed optimum; the tests hold it on the reference's quadratic).

Collectives, called on each rank in explicit SPMD (``dist/spmd.py``):

  * ``compressed_psum(grads, err, mesh, axes)`` — quantize ``g + err`` per
    leaf, all-reduce the dequantized float32 payload over ``axes``
    (recorded, as every collective), return the reduced grads and the new
    local error state ``(g + err) - deq``;
  * ``compressed_allreduce_stacked(grads, err, mesh)`` — each rank holds
    its row of a tree stacked over the mesh's shards; returns the shard
    mean (this rank's row of it) with the error carried per shard.

As in the reference, no training path calls them: this is a library.
Trees are dicts (flat dotted names or nested) of tensors.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist import spmd

__all__ = [
    "CHUNK", "quantize_int8", "dequantize_int8", "compressed_bytes",
    "init_error_state", "compressed_psum", "compressed_allreduce_stacked",
]

CHUNK = 256          # values per scale; payload = N int8 + N/CHUNK f32


def quantize_int8(x: torch.Tensor):
    """x (any shape) -> (q int8 (n_chunks, CHUNK), scale float32
    (n_chunks, 1)).

    Per-chunk symmetric quantization: scale = amax/127, q = round(x/scale)
    (round half to even, as ``jnp.round``).  An all-zero chunk keeps
    scale 0 and dequantizes to exact zeros."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    chunks = flat.reshape(-1, CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(chunks / torch.where(scale > 0, scale, 1.0))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape))


def compressed_bytes(x) -> int:
    """Wire bytes of the compressed form (int8 payload + per-chunk scale)."""
    n_chunks = -(-int(x.numel()) // CHUNK)
    return n_chunks * CHUNK + n_chunks * 4


def _map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_error_state(grads):
    """Zero EF carry, one float32 buffer per gradient leaf."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def compressed_psum(grads, err, mesh, axes=("data",)):
    """Quantized all-reduce with error feedback, on each rank.

    Per leaf: gf = g + err, its non-finite values set to 0 (one inf or NaN
    would make the chunk's scale non-finite and poison the carry for good;
    the train step's own NaN guard decides whether to skip the update);
    (q, s) = quantize(gf); the dequantized payload is summed over ``axes``
    and the new local error is ``gf - deq``.  Returns
    ``(reduced_grads, new_err)``."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        gf = torch.where(torch.isfinite(gf), gf, 0.0)
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s, gf.shape)
        total = deq
        for ax in axes:
            total = spmd.all_reduce(total, mesh, ax, "compressed psum")
        return total.to(g.dtype), gf - deq

    pairs = _map(one, grads, err)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def compressed_allreduce_stacked(grads, err, mesh):
    """All-reduce-mean for trees stacked over the mesh's shards.

    The whole leaves are ``(n_shards, ...)`` with the leading axis laid
    over every mesh axis; each rank passes its row block (its EF carry
    likewise), quantizes it plus its carry, the dequantized payloads are
    summed over the whole mesh, and each rank's output row is the global
    mean.  Returns ``(mean_grads, new_err)``, this rank's blocks."""
    axes = spmd.axis_names(mesh)
    n = math.prod(spmd.axis_size(mesh, a) for a in axes)
    total, new_err = compressed_psum(grads, err, mesh, axes=axes)
    return _map(lambda x: x / n, total), new_err
