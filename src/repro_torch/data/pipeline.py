"""Deterministic, restart-safe synthetic data, the port of
``repro.data.pipeline``.

A batch is a pure function of (seed, step): ``stream.batch(step)`` always
returns the same NumPy batch for the same config, bit for bit the
reference's, so a run restarted from a step-``k`` checkpoint sees exactly
the batches it would have seen (no iterator state to persist).

  * :class:`SyntheticLMStream` — token LM batches with a learnable bigram
    structure (75 % deterministic continuation, 25 % noise); for
    embeddings-input archs, (B, S, d) float32 embeddings.
  * :class:`SyntheticM3ViTStream` — Cityscapes-shaped multi-task batches
    (image, semseg labels, depth labels) for the paper's model.

Batches stay NumPy on the host.  :func:`device_transform` is the training
loop's ``batch_transform``: each array goes to the card through
page-locked memory, copied without blocking the host.  :func:`prefetch`
runs the stream (and a transform) a few batches ahead on a thread.
:func:`shard_for` is the transform of training over a mesh: this rank's
rows, put on its device the same way.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "SyntheticLMStream", "SyntheticM3ViTStream",
           "make_stream", "prefetch", "device_transform", "shard_for"]


@dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int = 0          # 0 => embeddings input (frontend stub)
    d_model: int = 0             # used when vocab_size == 0
    seed: int = 0
    kind: str = "lm"             # lm | m3vit
    image_hw: tuple = (128, 256)
    num_seg_classes: int = 19


class SyntheticLMStream:
    """Batches are pure functions of (seed, step): restart == replay."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # a fixed mixing map gives the stream learnable bigram structure
        if cfg.vocab_size:
            r = np.random.default_rng(cfg.seed ^ 0x5EED)
            self._next_tok = r.integers(
                0, cfg.vocab_size, size=(cfg.vocab_size,), dtype=np.int64)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        r = np.random.default_rng((cfg.seed << 20) ^ step)
        if cfg.vocab_size == 0:
            x = r.normal(size=(cfg.batch, cfg.seq_len, cfg.d_model)).astype(
                np.float32)
            labels = r.integers(0, max(cfg.d_model, 2),
                                size=(cfg.batch, cfg.seq_len)).astype(np.int32)
            return {"inputs": x, "labels": labels}
        toks = np.empty((cfg.batch, cfg.seq_len), dtype=np.int64)
        toks[:, 0] = r.integers(0, cfg.vocab_size, size=(cfg.batch,))
        noise = r.integers(0, cfg.vocab_size, size=(cfg.batch, cfg.seq_len))
        use_noise = r.random((cfg.batch, cfg.seq_len)) < 0.25
        for t in range(1, cfg.seq_len):
            nxt = self._next_tok[toks[:, t - 1]]
            toks[:, t] = np.where(use_noise[:, t], noise[:, t], nxt)
        inputs = toks.astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((cfg.batch, 1), -100, dtype=np.int64)],
            axis=1).astype(np.int32)
        return {"inputs": inputs, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticM3ViTStream:
    """Multi-task (image, semseg, depth) batches for the paper's M³ViT."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        h, w = cfg.image_hw
        r = np.random.default_rng((cfg.seed << 20) ^ step)
        # piecewise-constant "scenes": blocks of one class and depth, so
        # both tasks are learnable from local texture
        bh, bw = h // 8, w // 8
        cls = r.integers(0, cfg.num_seg_classes, size=(cfg.batch, bh, bw))
        cls_full = np.repeat(np.repeat(cls, 8, axis=1), 8, axis=2)
        depth = (cls_full.astype(np.float32) + 1.0) / cfg.num_seg_classes
        img = (cls_full[..., None].astype(np.float32) / cfg.num_seg_classes
               + 0.1 * r.normal(size=(cfg.batch, h, w, 3))).astype(np.float32)
        return {"image": img, "semseg": cls_full.astype(np.int32),
                "depth": depth.astype(np.float32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_stream(cfg: DataConfig):
    return SyntheticM3ViTStream(cfg) if cfg.kind == "m3vit" \
        else SyntheticLMStream(cfg)


def device_transform(device="cuda") -> Callable[[dict], dict]:
    """A ``batch_transform`` putting each NumPy array of a batch on
    ``device`` as a tensor: on the card through page-locked host memory
    with a non-blocking copy (the caching host allocator keeps the pinned
    buffer alive until the copy is done); on the CPU a plain tensor."""
    dev = resolve_device(device)

    def put(batch: dict) -> dict:
        out = {}
        for name, arr in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[name] = t.to(dev)
        return out

    return put


def shard_for(batch: dict, rules, device="cuda",
              batch_axes=("pod", "data"), accum_steps: int = 1) -> dict:
    """This rank's rows of a host batch under ``rules`` (the rows
    ``dist.spmd.batch_rows`` gives, over the mesh's axes among
    ``batch_axes``), each put on ``device`` as :func:`device_transform`
    puts it.  With ``accum_steps`` microbatches a rank takes its rows of
    each microbatch, so that its i-th local microbatch is its share of
    the one-device step's i-th.  The batch must divide over the axes."""
    from repro_torch.dist import spmd

    put = device_transform(device)
    out = {}
    for name, arr in batch.items():
        n = arr.shape[0]
        per = n // accum_steps
        shards, _, _ = spmd.batch_shard(per, rules, batch_axes)
        want = 1
        for a in rules.batch_axes:
            if a in batch_axes:
                want *= spmd.axis_size(rules.mesh, a)
        if n % accum_steps or shards != want:
            raise ValueError(f"{name}: a batch of {n} rows in "
                             f"{accum_steps} microbatches does not divide "
                             f"over {want} shards")
        rows = spmd.batch_rows(per, rules, batch_axes)
        micro = np.asarray(arr).reshape((accum_steps, per) + arr.shape[1:])
        out[name] = np.ascontiguousarray(micro[:, rows]).reshape(
            (-1,) + arr.shape[1:])
    return put(out)


def prefetch(stream, n: int = 2, start_step: int = 0, transform=None):
    """Thread-backed prefetch: yields (step, batch), ``n`` batches ahead.

    ``transform`` (e.g. :func:`device_transform`) runs on the producer
    thread so the copies overlap the consumer's step.
    """
    q: queue.Queue = queue.Queue(maxsize=n)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            b = stream.batch(step)
            if transform is not None:
                b = transform(b)
            q.put((step, b))
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        try:  # unblock a producer waiting on a full queue
            q.get_nowait()
        except queue.Empty:
            pass
