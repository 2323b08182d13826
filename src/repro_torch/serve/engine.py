"""Batched LM serving: prefill, then decode over KV caches — the port of
``repro.serve.engine`` (``ServeConfig``, ``ServingEngine``) for
single-device serving of the attention families.

A static batch of prompts is prefilled (in one pass, or in fixed-size
chunks) into per-layer KV caches on the card, then decoded token by token
with greedy or temperature sampling; per-request EOS stops a row early.
The caches are written in place between steps.  Meshes (``rules``),
quantized KV caches, asynchronous expert paging, the prefix cache,
recurrent families and embedding-input frontends come with later slices of
the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.ops.policy import ComputePolicy
from repro_torch.train.step import make_serve_step

__all__ = ["ServeConfig", "ServingEngine", "is_recurrent"]

_RECURRENT = ("mlstm", "slstm", "rglru_mlp")


def is_recurrent(cfg: ArchConfig) -> bool:
    """True when the arch carries recurrent state (no KV cache semantics)."""
    return any(k in _RECURRENT for k in cfg.block_pattern)


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0       # 0 => greedy
    eos_id: int = -1               # -1 => never stop early
    seed: int = 0                  # seeds the sampling generator
    prefill_chunk: int = 0         # >0: chunked prefill
    # compute policy for every serving step; None keeps the arch config's
    policy: Optional[ComputePolicy] = None
    kv_quant: Optional[str] = None     # "int8" comes with a later slice
    async_paging: bool = False         # the vision backend's; later slice
    prefix_cache: int = 0              # scheduler prefix trie; later slice


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with the {where} slice of the "
                               "port")


class ServingEngine:
    """``generate(prompts, max_new_tokens)`` over ``params`` (the flat
    dotted-name dict) on ``device`` (default: the card)."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 rules=None, *, device="cuda"):
        if rules is not None:
            raise _later("mesh serving (rules)", "distribution")
        kv_quant = scfg.kv_quant if scfg.kv_quant is not None \
            else cfg.kv_quant
        if kv_quant != "none":
            raise _later(f"kv_quant={kv_quant!r}", "packed-formats")
        if scfg.async_paging:
            raise _later("asynchronous expert paging", "paged serving")
        if scfg.prefix_cache:
            raise _later("the prefix cache", "scheduler")
        if is_recurrent(cfg):
            raise _later(f"recurrent serving ({cfg.name})", "recurrent")
        if cfg.embed_input != "tokens":
            raise _later(f"embedding-input frontends ({cfg.name})",
                         "modality")
        self.device = resolve_device(device)
        if scfg.policy is not None:
            cfg = replace(cfg, policy=scfg.policy)
        self.cfg, self.scfg = cfg, scfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._steps: dict[int, tuple] = {}

    def steps(self, task_id: int = 0):
        """(prefill, decode) of ``train.step.make_serve_step``, per task."""
        if task_id not in self._steps:
            self._steps[task_id] = make_serve_step(self.cfg, task_id=task_id)
        return self._steps[task_id]

    def _sample(self, logits, generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)    # the first maximum
        # Gumbel-max, the algorithm of jax.random.categorical
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = u.clamp_min(torch.finfo(u.dtype).tiny)
        return torch.argmax(logits / self.scfg.temperature
                            - torch.log(-torch.log(u)), dim=-1)

    def _prefill(self, prompts, state, task_id):
        cfg, chunk = self.cfg, self.scfg.prefill_chunk
        b, s0 = prompts.shape
        windowed = any("attn_local" in k for k in cfg.block_pattern)
        if not (chunk and not windowed and s0 > chunk):
            prefill, _ = self.steps(task_id)
            return prefill(self.params, prompts, state)
        # fixed-size chunks; a short final chunk is padded, its pad rows
        # land at positions >= s0, past every later cache_len (the first
        # decode overwrites position s0), and the logits are read at the
        # last real position
        n_full, rem = divmod(s0, chunk)
        if rem == 0:
            n_mid, last = n_full - 1, chunk - 1
            final = prompts[:, n_mid * chunk:]
        else:
            tail = prompts[:, n_full * chunk:]
            final = torch.cat([tail, tail.new_zeros((b, chunk - rem))], 1)
            n_mid, last = n_full, rem - 1
        for i in range(n_mid):
            M.forward(self.params, prompts[:, i * chunk:(i + 1) * chunk],
                      cfg, state=state, cache_index=i * chunk,
                      task_id=task_id, return_state=True, logits_mode="last")
        logits, state, _ = M.forward(self.params, final, cfg, state=state,
                                     cache_index=n_mid * chunk,
                                     task_id=task_id, return_state=True)
        return logits[:, last], state

    def generate(self, prompts, max_new_tokens: int, task_id: int = 0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts: (B, S0) int token ids (NumPy or tensor).  Returns
        (B, max_new_tokens) int32 NumPy tokens; after a row emits
        ``eos_id`` it holds ``eos_id``.  Temperature sampling draws from
        ``generator`` (default: a new one on the device seeded with
        ``ServeConfig.seed``)."""
        cfg, scfg = self.cfg, self.scfg
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s0 = prompts.shape
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(scfg.seed)
        out = np.zeros((b, max_new_tokens), np.int32)
        done = np.zeros((b,), bool)
        with torch.inference_mode():
            state = M.init_state(cfg, b, scfg.max_len, device=self.device)
            logits, state = self._prefill(prompts, state, task_id)
            _, decode = self.steps(task_id)
            tok = self._sample(logits, generator)
            for i in range(max_new_tokens):
                host = tok.cpu().numpy()
                out[:, i] = np.where(done, scfg.eos_id, host)
                if scfg.eos_id >= 0:
                    done |= host == scfg.eos_id
                    if done.all():
                        break
                logits, state = decode(self.params, tok[:, None], state,
                                       s0 + i)
                tok = self._sample(logits, generator)
        return out
