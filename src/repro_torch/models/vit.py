"""M³ViT — the paper's multi-task mixture-of-experts ViT, the port of
``repro.models.vit``.

Patch embedding → the block stack (even blocks dense, odd blocks MoE with
per-task gating) → task heads for semantic segmentation and depth.  The
functional :func:`forward` takes the flat dotted-name parameter dict (see
``repro_torch.tree``); :class:`M3ViT` holds the same parameters as an
``nn.Module`` whose ``state_dict()`` keys are those names and stays the
inference module.  :func:`multitask_loss` is the training loss over the
functional forward (``train.make_train_step`` takes it as ``loss_fn``).
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

__all__ = ["M3ViT", "init_params", "param_specs", "forward",
           "multitask_loss", "patchify", "embed_patches", "apply_head"]


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
    params = _init_tree(np.random.default_rng(seed), cfg, dtype,
                        num_seg_classes)
    return {k: v.to(dev) for k, v in flatten(params).items()}


def param_specs(cfg: ArchConfig, dtype=None,
                num_seg_classes=M.NUM_SEG_CLASSES,
                device="meta") -> dict[str, torch.Tensor]:
    """The parameters' shapes and dtypes, as :func:`init_params` builds
    them, on ``meta`` (no values drawn)."""
    meta = torch.device(device)
    params = _init_tree(meta, cfg, dtype, num_seg_classes)
    return {k: v.to(meta) for k, v in flatten(params).items()}


def _init_tree(rng, cfg: ArchConfig, dtype, num_seg_classes) -> dict:
    dtype = dtype or cfg.activation_dtype
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
    return params


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


def multitask_loss(params, images, labels, cfg: ArchConfig, task: str,
                   aux_weight: float = 0.01):
    """The reference's loss for one task: semseg cross-entropy over the
    (B, H, W) int class labels, or depth RMSE against (B, H, W) float
    labels (the paper's), plus ``aux_weight`` times the MoE load-balance
    loss.  Returns (loss, (task loss, aux)).

    On a rank's rows of a split batch (``dist.spmd.batch_split``, as the
    train step runs it over a mesh) each is this rank's share of the
    whole batch's: the summed cross-entropy over the whole batch's pixel
    count, the RMSE of the squared errors summed over the ranks, and the
    aux loss, divided by the number of shards; the shares add up to the
    one-device loss."""
    from repro_torch.dist import spmd

    pred, aux = forward(params, images, cfg, task=task)
    shards = spmd.batch_shards()
    if task == "semseg":
        logp = torch.log_softmax(pred, dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        loss = nll.mean() if shards == 1 else \
            nll.sum() / (nll.numel() * shards)
    elif shards == 1:
        loss = torch.sqrt(torch.mean((pred - labels) ** 2) + 1e-8)
    else:
        sq = spmd.batch_total(((pred - labels) ** 2).sum(),
                              "depth squared error")
        loss = torch.sqrt(sq / (pred.numel() * shards) + 1e-8) / shards
    if shards > 1:
        aux = aux / shards
    return loss + aux_weight * aux, (loss, aux)


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
