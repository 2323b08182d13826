"""Batched M³ViT serving, the port of ``repro.serve.vision.M3ViTServer``.

``infer(images, task)`` runs patch embed → the blocks layer by layer →
final norm → task head, under the config's compute policy, and returns the
prediction through a pinned host buffer.  The MoE blocks either keep every
expert resident (``core.moe.apply_moe``, the default) or page their
experts through one ``serve.expert_cache.PagedMoE`` per layer, synchronous
or through a shared copy-stream ``TransferEngine``.  Task switching is the
paper's §IV-F gate index switch, plus, when paging, a prefetch of the
incoming task's usage-hot experts.  Meshes, factored experts and the
scheduler's buckets come with later slices of the port and raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import m3vit as MV
from repro_torch.configs.base import ArchConfig
from repro_torch.core import moe as moe_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vit as V
from repro_torch.ops.policy import use_policy
from repro_torch.serve.expert_cache import PagedMoE
from repro_torch.serve.transfer import TransferEngine
from repro_torch.tree import index, unflatten

__all__ = ["M3ViTServer"]


class M3ViTServer:
    """Layer-by-layer M³ViT executor, all-resident or with paged MoE
    blocks.

    ``params`` is the flat dotted-name dict (``models.vit.init_params`` or
    ``bridge.params_from_jax``); it is moved to ``device`` (default: the
    card), except the expert weights of paged layers, which stay in a
    pinned host store and reach the card a slot at a time.

    Paging is on when any of ``resident_fraction < 1``,
    ``expert_budget_bytes`` (per MoE layer; beats the fraction),
    ``placement`` (a policy name or ``PlacementPolicy``; a name builds one
    policy per layer), ``async_paging`` (one copy-stream
    :class:`TransferEngine` shared by every layer) or ``transfer_engine``
    (an injected transport, e.g. ``FakeTransferEngine``) is given.  Without
    them (the default, ``resident_fraction=1.0``) every expert stays
    resident and the MoE blocks run ``apply_moe``, which carries the fused
    ``moe_fused`` kernel under ``moe_ffn="cuda_fused"``.  The reference
    always pages, even at 1.0; under the staged policies (``eager``,
    ``blocked``, ``cuda``) both paths give the same bits, since the paged
    layer's waves run the same staged expert FFN and combine.  Under
    ``cuda_fused`` the waves stay staged, so paged output agrees with the
    fused all-resident output to the kernels' tolerance.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 resident_fraction: float = 1.0,
                 expert_budget_bytes: Optional[int] = None,
                 rules=None, ep_mesh=None, async_paging: bool = False,
                 transfer_engine=None, factor=None, placement=None,
                 device="cuda"):
        if cfg.family != "vit-moe":
            raise ValueError("M3ViTServer serves the vit-moe family")
        if rules is not None or ep_mesh is not None:
            raise NotImplementedError(
                "mesh serving comes with ROADMAP.md queue 1 item 6")
        if factor is not None:
            raise NotImplementedError(
                "factored experts come with ROADMAP.md queue 1 item 3")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mcfg = T.moe_config(cfg)
        paging = (resident_fraction < 1.0 or expert_budget_bytes is not None
                  or placement is not None or async_paging
                  or transfer_engine is not None)
        if transfer_engine is None and async_paging:
            transfer_engine = TransferEngine(device=self.device)
        self.engine = transfer_engine
        experts = set(moe_lib.expert_param_names(self.mcfg))

        def on_host(name: str) -> bool:       # a paged layer's expert leaf
            path = name.split(".")
            return paging and path[-2:-1] == ["moe"] and path[-1] in experts

        self.params = {k: v if on_host(k) else v.to(self.device)
                       for k, v in params.items()}
        tree = unflatten(self.params)
        self.tree = tree
        period = cfg.period
        n_scan = cfg.num_layers // period
        self.kinds = [cfg.block_pattern[i % period]
                      for i in range(cfg.num_layers)]
        self.layer_params = []
        for i in range(cfg.num_layers):
            p, b = divmod(i, period)
            if p < n_scan:
                self.layer_params.append(index(tree["layers"][f"b{b}"], p))
            else:
                self.layer_params.append(tree["rest"][str(i - n_scan * period)])
        self.paged = {
            i: PagedMoE(self.layer_params[i]["moe"], self.mcfg,
                        resident_fraction=resident_fraction,
                        budget_bytes=expert_budget_bytes,
                        transfer_engine=self.engine, placement=placement,
                        device=self.device)
            for i, kind in enumerate(self.kinds)
            if paging and kind == "attn_moe"
        }

    def _dense_block(self, bp, x):
        h = L.apply_norm(bp["ln1"], x, self.cfg)
        a, _ = L.apply_attention(bp["attn"], h, self.cfg, causal=False)
        x = x + a
        h = L.apply_norm(bp["ln2"], x, self.cfg)
        return x + L.apply_mlp(bp["mlp"], h, self.cfg)

    def _moe_block(self, i, bp, x, task_id):
        h = L.apply_norm(bp["ln1"], x, self.cfg)
        a, _ = L.apply_attention(bp["attn"], h, self.cfg, causal=False)
        x = x + a
        h = L.apply_norm(bp["ln2"], x, self.cfg)
        if i in self.paged:
            y, _ = self.paged[i](h, task_id=task_id)
        else:
            y, _ = moe_lib.apply_moe(bp["moe"], self.mcfg, h,
                                     task_id=task_id)
        return x + y

    def infer(self, images, task) -> np.ndarray:
        """images: (B, H, W, 3) float32 (NumPy or tensor) or (B, T, d) patch
        embeddings; ``task``: name or index.  Returns the dense prediction
        as NumPy, in host memory of its own (no two calls share it)."""
        task_id = MV.TASKS.index(task) if isinstance(task, str) else int(task)
        x = torch.as_tensor(images, device=self.device)
        with torch.inference_mode(), use_policy(self.cfg.policy):
            x = V.embed_patches(self.tree, x, self.cfg)
            for i, (kind, bp) in enumerate(zip(self.kinds,
                                               self.layer_params)):
                if kind == "attn_moe":
                    x = self._moe_block(i, bp, x, task_id)
                else:
                    x = self._dense_block(bp, x)
            feats = L.apply_norm(self.tree["final_norm"], x, self.cfg)
            y = V.apply_head(self.tree, feats, MV.TASKS[task_id])
            # a page-locked buffer from the caching host allocator: the
            # copy runs at the link's rate (a pageable one is staged), and
            # the returned array keeps the buffer alive
            out = torch.empty(y.shape, dtype=y.dtype,
                              pin_memory=self.device.type == "cuda")
            out.copy_(y, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()

    def prefetch(self, task_id: int) -> None:
        """Warm every paged MoE layer's cache with the task's hot set.
        With async paging this only SUBMITS the copies; each layer fences
        its own experts when its wave needs them.  A no-op when every
        expert is resident."""
        for paged in self.paged.values():
            paged.prefetch(task_id)

    # the scheduler's lookahead hook: the same as prefetch, named for the
    # cross-bucket case (stream the NEXT bucket's hot set behind the
    # quantum about to run)
    lookahead = prefetch

    def cache_stats(self) -> dict[str, Any]:
        """Cache counters summed over the paged layers (hits, misses,
        evictions, bytes paged, hit rate, the resident fraction) and, with
        a transfer engine, its one shared ledger (stall, hidden time,
        overlap ratio, per-tag)."""
        agg = {"hits": 0, "misses": 0, "evictions": 0, "bytes_paged": 0}
        async_agg = {"async_prefetches": 0, "inflight_joins": 0,
                     "async_cancelled": 0}
        frac = 1.0
        for paged in self.paged.values():
            s = paged.cache.stats()
            for k in agg:
                agg[k] += s[k]
            for k in async_agg:
                async_agg[k] += s.get(k, 0)
            frac = s["resident_fraction"]
        tot = agg["hits"] + agg["misses"]
        agg["hit_rate"] = agg["hits"] / tot if tot else 1.0
        agg["resident_fraction"] = frac
        if self.engine is not None:
            # one engine serves every layer: its ledger is read once
            agg.update(async_agg)
            agg["stall_s"] = self.engine.stats.stall_s
            agg["hidden_s"] = self.engine.stats.hidden_s
            agg["overlap_ratio"] = self.engine.stats.overlap_ratio
            agg["transfer_tags"] = self.engine.stats.tags_dict()
        return agg

    def reset_stats(self) -> None:
        """Zero the cache counters AND the shared transfer ledger — call at
        a measurement boundary so stall_s/overlap_ratio cover one
        interval."""
        for paged in self.paged.values():
            paged.cache.reset_stats()
        if self.engine is not None:
            self.engine.reset_stats()
