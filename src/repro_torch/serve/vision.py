"""Batched M³ViT serving, the port of ``repro.serve.vision.M3ViTServer``.

``infer(images, task)`` runs patch embed → the blocks layer by layer →
final norm → task head, under the config's compute policy, and returns the
prediction through a pinned host buffer.  The MoE blocks either keep every
expert resident (``core.moe.apply_moe``, the default) or page their
experts through one ``serve.expert_cache.PagedMoE`` per layer, synchronous
or through a shared copy-stream ``TransferEngine``.  Task switching is the
paper's §IV-F gate index switch, plus, when paging, a prefetch of the
incoming task's usage-hot experts.  The parameters may be packed
(``quant.quantize_tree``: QTensor leaves), and ``factor=(kind, rank,
delta_bits)`` factorizes each MoE layer's experts into a shared basis and
per-expert deltas; paged layers then page the packed tensors and pin the
basis.

Mesh serving (one process a rank, each calling ``infer`` with the same
images): under ``rules`` the images are batch-sharded over the data axes
and the predictions all-gathered back; the dense blocks' MLPs run
tensor-parallel over ``model`` (each rank holds its block of the hidden
columns, ``serve.engine.local_params``), while attention, whose three
heads do not divide the axis, the patch embedding and the task heads stay
whole on every rank (the reference's server replicates the whole trunk);
and every
MoE layer pages expert-parallel over the ``model`` axis through a
``ShardedExpertCache`` (per-shard slot banks: the same per-device budget
holds ``shards ×`` more resident experts).  ``ep_mesh`` alone is the
hybrid placement of the M³ViT line of work: the dense trunk stays local
and only the MoE layers go expert-parallel.  Either way the MoE layers
page, as the reference's always do, and the stats carry ``shard_load``.

``VisionBackend`` adapts the server to the ``serve.scheduler.Scheduler``
bucket protocol: a request's prompt is an image (H, W, 3); a bucket stages
up to ``slots`` same-task requests and completes them in one ``infer``,
a partial batch padded by repeating its first image.  A frame's result
does not depend on the batch it rides in, so a request served through the
scheduler gets the bits a direct ``infer`` gives it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import m3vit as MV
from repro_torch.configs.base import ArchConfig
from repro_torch.core import moe as moe_lib
from repro_torch.dist import spmd
from repro_torch.dist.sharding import use_rules
from repro_torch.factor import factorize_tree
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vit as V
from repro_torch.ops.policy import use_policy
from repro_torch.serve.engine import local_params, shard_batch
from repro_torch.serve.expert_cache import PagedMoE
from repro_torch.serve.scheduler import Request
from repro_torch.serve.slo.tiers import is_preemptible
from repro_torch.serve.transfer import TransferEngine
from repro_torch.tree import index, unflatten

__all__ = ["M3ViTServer", "VisionBackend"]


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

    ``params`` may hold ``QTensor`` leaves (``quant.quantize_tree``), and
    ``factor=(kind, rank, delta_bits)`` (``kind`` ``"rank"`` or
    ``"butterfly"``, ``delta_bits`` None, 8 or 4) factorizes each MoE
    layer's expert stack into a basis and per-expert deltas after the
    per-layer slice, as the reference does: a layer's experts share that
    layer's basis.  Serve them under a policy whose ``linear`` /
    ``moe_grouped_gemm`` are ``eager_int8`` / ``eager_factored``.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 resident_fraction: float = 1.0,
                 expert_budget_bytes: Optional[int] = None,
                 rules=None, ep_mesh=None, async_paging: bool = False,
                 transfer_engine=None, factor=None, placement=None,
                 device="cuda"):
        if cfg.family != "vit-moe":
            raise ValueError("M3ViTServer serves the vit-moe family")
        self.cfg = cfg
        self.rules = rules
        self.device = resolve_device(device)
        self.mcfg = T.moe_config(cfg)
        mesh = ep_mesh if ep_mesh is not None else (
            rules.mesh if rules is not None else None)
        paging = (resident_fraction < 1.0 or expert_budget_bytes is not None
                  or placement is not None or async_paging
                  or transfer_engine is not None or mesh is not None)
        if transfer_engine is None and async_paging:
            transfer_engine = TransferEngine(device=self.device)
        self.engine = transfer_engine
        experts = set(moe_lib.expert_param_names(self.mcfg))

        def on_host(name: str) -> bool:       # a paged layer's expert leaf
            path = name.split(".")
            return paging and path[-2:-1] == ["moe"] and path[-1] in experts

        # the trunk's blocks under rules: a rank's block of every leaf the
        # table splits over model (the MLPs); the patch embed and the task
        # heads have no entry in the table and stay whole
        self.params = local_params(
            {k: v if on_host(k) else v.to(self.device)
             for k, v in params.items()}, cfg, rules)
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
        if factor is not None:
            f_kind, f_rank, f_bits = factor
            for i, kind in enumerate(self.kinds):
                if kind == "attn_moe":
                    lp = dict(self.layer_params[i])
                    lp["moe"] = factorize_tree(lp["moe"], kind=f_kind,
                                               rank=f_rank,
                                               delta_bits=f_bits)
                    self.layer_params[i] = lp
        self.paged = {
            i: PagedMoE(self.layer_params[i]["moe"], self.mcfg,
                        resident_fraction=resident_fraction,
                        budget_bytes=expert_budget_bytes,
                        transfer_engine=self.engine, placement=placement,
                        device=self.device, mesh=mesh)
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
        b = x.shape[0]
        x = shard_batch(x, self.rules)      # this rank's images
        with torch.inference_mode(), use_policy(self.cfg.policy), \
                use_rules(self.rules), spmd.batch_split(self.rules, b):
            x = V.embed_patches(self.tree, x, self.cfg)
            for i, (kind, bp) in enumerate(zip(self.kinds,
                                               self.layer_params)):
                if kind == "attn_moe":
                    x = self._moe_block(i, bp, x, task_id)
                else:
                    x = self._dense_block(bp, x)
            feats = L.apply_norm(self.tree["final_norm"], x, self.cfg)
            y = V.apply_head(self.tree, feats, MV.TASKS[task_id])
            if self.rules is not None:
                y = spmd.gather_batch(y, self.rules, b, "vision predictions")
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
        shard_load = None
        placement: dict[str, Any] = {}
        for paged in self.paged.values():
            s = paged.cache.stats()
            for k in agg:
                agg[k] += s[k]
            for k in async_agg:
                async_agg[k] += s.get(k, 0)
            frac = s["resident_fraction"]
            if "shard_load" in s:       # expert-parallel layers only
                sl = np.asarray(s["shard_load"], np.float64)
                shard_load = sl if shard_load is None else shard_load + sl
                p = s["placement"]
                placement = {
                    "policy": p["policy"],
                    "generation": max(placement.get("generation", 0),
                                      p["generation"]),
                    "plan_swaps": placement.get("plan_swaps", 0)
                    + p["plan_swaps"],
                    "migrations": placement.get("migrations", 0)
                    + p["migrations"],
                    "replications": placement.get("replications", 0)
                    + p["replications"],
                    "max_replicas": max(placement.get("max_replicas", 1),
                                        p["max_replicas"]),
                }
        tot = agg["hits"] + agg["misses"]
        agg["hit_rate"] = agg["hits"] / tot if tot else 1.0
        agg["resident_fraction"] = frac
        if shard_load is not None:
            agg["shard_load"] = [float(v) for v in shard_load]
            s_tot = float(shard_load.sum())
            agg["shard_load_imbalance"] = (
                float(shard_load.max() * shard_load.size / s_tot)
                if s_tot > 0 else 0.0)
            agg["placement"] = placement
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


class VisionTaskBucket:
    """Stages up to ``slots`` same-task requests and serves them in one
    batched forward (a vision request completes in a single quantum)."""

    def __init__(self, backend: "VisionBackend", task_id: int, slots: int):
        self.backend = backend
        self.task_id = task_id
        self.slots = slots
        self.staged: list[Request] = []
        self.steps = 0
        self.slot_steps = 0

    @property
    def active(self) -> int:
        return len(self.staged)

    @property
    def free_slots(self) -> list[int]:
        return list(range(self.slots - len(self.staged)))

    def admit(self, req: Request, now: float) -> list[Request]:
        req.t_admit = now
        self.staged.append(req)
        return []

    def bump_batch(self) -> Optional[Request]:
        """SLO preemption hook: displace the most recently staged batch-tier
        request so a due interactive one can take its place in the next
        forward.  Inference is stateless, so a bump is result-identical —
        the request just rides a later batch."""
        for i in range(len(self.staged) - 1, -1, -1):
            if is_preemptible(self.staged[i]):
                req = self.staged.pop(i)
                req.preemptions += 1
                return req
        return None

    def run_quantum(self, n: int, now_fn, admit_cb=None) -> list[Request]:
        if admit_cb is not None:
            admit_cb()      # top up the batch before launching it
        if not self.staged:
            return []
        server = self.backend.server
        server.prefetch(self.task_id)
        batch = self.staged
        self.staged = []
        imgs = np.stack([np.asarray(r.prompt) for r in batch])
        if imgs.shape[0] < self.slots:   # the reference's fixed batch
            pad = np.repeat(imgs[:1], self.slots - imgs.shape[0], axis=0)
            imgs = np.concatenate([imgs, pad], axis=0)
        preds = server.infer(imgs, self.task_id)
        now = now_fn()
        self.steps += 1
        self.slot_steps += len(batch)
        for i, req in enumerate(batch):
            req.result = preds[i]
            req.t_first = req.t_done = now
        return batch


class VisionBackend:
    """Scheduler backend serving M³ViT semseg/depth through per-task
    buckets; the keywords are :class:`M3ViTServer`'s (``resident_fraction``
    defaults to 0.5, as the reference's)."""

    def __init__(self, cfg: ArchConfig, params, *,
                 resident_fraction: float = 0.5,
                 expert_budget_bytes: Optional[int] = None,
                 rules=None, ep_mesh=None, async_paging: bool = False,
                 transfer_engine=None, factor=None, placement=None,
                 device="cuda"):
        self.server = M3ViTServer(cfg, params,
                                  resident_fraction=resident_fraction,
                                  expert_budget_bytes=expert_budget_bytes,
                                  rules=rules, ep_mesh=ep_mesh,
                                  async_paging=async_paging,
                                  transfer_engine=transfer_engine,
                                  factor=factor, placement=placement,
                                  device=device)
        self.num_tasks = len(MV.TASKS)
        self.usage = None   # per-layer usage lives inside each PagedMoE

    def make_bucket(self, task_id: int, slots: int) -> VisionTaskBucket:
        return VisionTaskBucket(self, task_id, slots)

    def lookahead(self, task_id: int) -> None:
        """Scheduler hook: stream task ``task_id``'s usage-hot experts
        behind the quantum about to run.  A no-op without a transfer
        engine — a synchronous lookahead would block before the quantum
        and evict the current task's set."""
        if self.server.engine is not None:
            self.server.lookahead(task_id)

    def cache_stats(self) -> dict[str, Any]:
        return self.server.cache_stats()

    def reset_stats(self) -> None:
        self.server.reset_stats()
