"""M³ViT — the paper's multi-task mixture-of-experts ViT, the port of
``repro.models.vit``.

Patch embedding → the block stack (even blocks dense, odd blocks MoE with
per-task gating) → task heads for semantic segmentation and depth.  The
functional :func:`forward` takes the flat dotted-name parameter dict (see
``repro_torch.tree``); :class:`M3ViT` holds the same parameters as an
``nn.Module`` whose ``state_dict()`` keys are those names.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import m3vit as M
from repro_torch.configs.base import ArchConfig
from repro_torch.core.moe import normal
from repro_torch.core.unified_linear import unified_linear
from repro_torch.models import transformer as T
from repro_torch.ops.policy import use_policy
from repro_torch.tree import flatten, unflatten

__all__ = ["M3ViT", "init_params", "forward", "patchify", "embed_patches",
           "apply_head"]


def patchify(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, nH*nW, P*P*C), row-major patches."""
    b, h, w, c = images.shape
    p = M.PATCH
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def init_params(seed: int, cfg: ArchConfig, dtype=None,
                num_seg_classes=M.NUM_SEG_CLASSES,
                device="cuda") -> dict[str, torch.Tensor]:
    """Random M³ViT parameters from ``seed`` with the reference's shapes,
    scales and dtypes (biases float32), as a flat dotted-name dict on
    ``device``."""
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    rng = np.random.default_rng(seed)
    d, p = cfg.d_model, M.PATCH
    params = T.init_params(rng, cfg, dtype)
    params["patch"] = {
        "w": normal(rng, (p * p * 3, d), 1.0 / math.sqrt(p * p * 3), dtype),
        "b": torch.zeros((d,), dtype=torch.float32),
        "pos": normal(rng, (M.NUM_PATCHES, d), 0.02, dtype),
    }
    sh = 1.0 / math.sqrt(d)
    params["heads"] = {
        "semseg": {"w": normal(rng, (d, p * p * num_seg_classes), sh, dtype),
                   "b": torch.zeros((p * p * num_seg_classes,),
                                    dtype=torch.float32)},
        "depth": {"w": normal(rng, (d, p * p), sh, dtype),
                  "b": torch.zeros((p * p,), dtype=torch.float32)},
    }
    return {k: v.to(dev) for k, v in flatten(params).items()}


def embed_patches(params, images, cfg: ArchConfig):
    """(B, H, W, 3) images or (B, T, d) embeddings -> (B, T, d) trunk
    inputs (patchify → linear patch embed → learned positions)."""
    if images.dim() == 4:
        tokens = patchify(images).to(cfg.activation_dtype)
        x = unified_linear(tokens, params["patch"]["w"],
                           params["patch"]["b"])
        return x + params["patch"]["pos"]
    return images.to(cfg.activation_dtype)


def apply_head(params, feats, task: str, num_seg_classes=M.NUM_SEG_CLASSES):
    """Task head over trunk features (B, T, d): semseg (B, H, W, classes)
    float32 logits; depth (B, H, W) float32."""
    b = feats.shape[0]
    p = M.PATCH
    nh, nw = M.IMAGE_H // p, M.IMAGE_W // p
    hp = params["heads"][task]
    y = unified_linear(feats, hp["w"], hp["b"], preferred_dtype=torch.float32)
    if task == "semseg":
        y = y.reshape(b, nh, nw, p, p, num_seg_classes)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, M.IMAGE_H, M.IMAGE_W,
                                                num_seg_classes)
    else:
        y = y.reshape(b, nh, nw, p, p).permute(0, 1, 3, 2, 4).reshape(
            b, M.IMAGE_H, M.IMAGE_W)
    return y.float()


def forward(params: dict[str, torch.Tensor], images, cfg: ArchConfig,
            task: str = "semseg", num_seg_classes=M.NUM_SEG_CLASSES):
    """images: (B, H, W, 3) float32 or patch embeddings (B, T, d), on the
    parameters' device.  Returns (prediction, aux_loss)."""
    tree = unflatten(params)
    task_id = M.TASKS.index(task)
    with use_policy(cfg.policy):
        x = embed_patches(tree, images, cfg)
        feats, _, aux = T.forward(tree, x, cfg, task_id=task_id)
        y = apply_head(tree, feats, task, num_seg_classes=num_seg_classes)
    return y, aux


class M3ViT(nn.Module):
    """M³ViT with its parameters registered under the dotted names.

    ``params`` (a flat dotted-name dict, e.g. from ``bridge.params_from_jax``)
    or random weights from ``seed``; ``device`` defaults to the card.
    """

    def __init__(self, cfg: ArchConfig, params=None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_params(seed, cfg, device=dev)
        for name, value in params.items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, nn.Module())
                mod = mod._modules[part]
            mod.register_parameter(
                leaf, nn.Parameter(value.to(dev), requires_grad=False))

    def param_dict(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, images, task: str = "semseg"):
        with torch.inference_mode():
            return forward(self.param_dict(), images, self.cfg, task=task)
