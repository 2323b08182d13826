"""Batched M³ViT serving, the port of the all-resident path of
``repro.serve.vision.M3ViTServer``.

``infer(images, task)`` runs patch embed → the blocks layer by layer (the
MoE blocks through ``core.moe.apply_moe`` with every expert resident) →
final norm → task head, under the config's compute policy.  Expert paging,
meshes, asynchronous transfers, factored experts and placement policies
come with the serving slice of the port (``PagedMoE``, the scheduler and
``launch/serve.py``); asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

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
from repro_torch.tree import index, unflatten

__all__ = ["M3ViTServer"]

_LATER = "comes with the paged serving slice of the port (PagedMoE, " \
         "scheduler, launch/serve.py)"


class M3ViTServer:
    """Layer-by-layer M³ViT executor with every expert resident.

    ``params`` is the flat dotted-name dict (``models.vit.init_params`` or
    ``bridge.params_from_jax``); it is moved to ``device`` (default: the
    card).
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 resident_fraction: float = 1.0,
                 expert_budget_bytes: Optional[int] = None,
                 rules=None, ep_mesh=None, async_paging: bool = False,
                 transfer_engine=None, factor=None, placement=None,
                 device="cuda"):
        if cfg.family != "vit-moe":
            raise ValueError("M3ViTServer serves the vit-moe family")
        if resident_fraction != 1.0 or expert_budget_bytes is not None:
            raise NotImplementedError(f"expert paging {_LATER}")
        if rules is not None or ep_mesh is not None:
            raise NotImplementedError(f"mesh serving {_LATER}")
        if async_paging or transfer_engine is not None:
            raise NotImplementedError(f"asynchronous paging {_LATER}")
        if factor is not None:
            raise NotImplementedError(f"factored experts {_LATER}")
        if placement is not None:
            raise NotImplementedError(f"expert placement {_LATER}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        tree = unflatten(self.params)
        self.tree = tree
        self.mcfg = T.moe_config(cfg)
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

    def _dense_block(self, bp, x):
        h = L.apply_norm(bp["ln1"], x, self.cfg)
        a, _ = L.apply_attention(bp["attn"], h, self.cfg, causal=False)
        x = x + a
        h = L.apply_norm(bp["ln2"], x, self.cfg)
        return x + L.apply_mlp(bp["mlp"], h, self.cfg)

    def _moe_block(self, bp, x, task_id):
        h = L.apply_norm(bp["ln1"], x, self.cfg)
        a, _ = L.apply_attention(bp["attn"], h, self.cfg, causal=False)
        x = x + a
        h = L.apply_norm(bp["ln2"], x, self.cfg)
        y, _ = moe_lib.apply_moe(bp["moe"], self.mcfg, h, task_id=task_id)
        return x + y

    def infer(self, images, task) -> np.ndarray:
        """images: (B, H, W, 3) float32 (NumPy or tensor) or (B, T, d) patch
        embeddings; ``task``: name or index.  Returns the dense prediction
        as NumPy."""
        task_id = MV.TASKS.index(task) if isinstance(task, str) else int(task)
        x = torch.as_tensor(images, device=self.device)
        with torch.inference_mode(), use_policy(self.cfg.policy):
            x = V.embed_patches(self.tree, x, self.cfg)
            for kind, bp in zip(self.kinds, self.layer_params):
                if kind == "attn_moe":
                    x = self._moe_block(bp, x, task_id)
                else:
                    x = self._dense_block(bp, x)
            feats = L.apply_norm(self.tree["final_norm"], x, self.cfg)
            y = V.apply_head(self.tree, feats, MV.TASKS[task_id])
        return y.cpu().numpy()
