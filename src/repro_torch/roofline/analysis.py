"""Three-term roofline of one step on one H100, the port of
``repro.roofline.analysis``.

    compute term    = counted FLOPs       / peak bf16 FLOP/s
    memory term     = counted bytes       / HBM bytes/s
    collective term = collective bytes    / NVLink bytes/s   (0 on one card)

On a mesh (the dry-run's ``--mesh 16x16`` / ``2x16x16``) the step is rank
0's share: its counts are one rank's, its collective bytes the bytes its
recorded collectives deliver to it (``op_cost.CostCounter.collective``),
and the bottleneck is the largest of the three terms.

The counts come from running the step under ``roofline/op_cost.py``'s
counter (on the card, on the CPU, or on ``meta`` where nothing is
computed), not from a compiled program: the port has no HLO.  So the
reference's HLO-only fields have no counterpart here —
``collective_bytes_from_hlo`` (no collectives on one device),
``xla_flops`` (XLA's own count, which takes a loop body once) and
``unparsed_loops`` (every loop of an eager step runs, and counts, as
often as it iterates).  The counted FLOPs and bytes keep the reference's
field names (``hlo_flops``, ``hlo_bytes``) so that records and tables
read alike; on one card ``chips`` is 1 and ``mesh`` is ``"1xH100"``.

``MODEL_FLOPS = 6·N·D`` (train) or ``2·N·D`` (inference), N the active
parameters, D the tokens: the useful-compute ratio MODEL_FLOPS / counted
FLOPs shows work the step does beyond the model's (attention, the
capacity rows of the experts, the LUT).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from repro_torch.configs.base import ArchConfig, Shape
from repro_torch.launch.mesh import HW
from repro_torch.roofline.op_cost import CostCounter

__all__ = ["RooflineReport", "analyze_step", "model_flops",
           "flash_kernel_bytes", "kernel_adjusted_terms", "MESH"]

MESH = "1xH100"


def model_flops(cfg: ArchConfig, shape: Shape) -> float:
    """6·N·D with N = active params (MoE-aware), D = tokens processed.

    For decode shapes D = global_batch (one token per sequence per step).
    """
    n = cfg.active_param_count()
    if shape.kind == "decode":
        d = shape.global_batch
    else:
        d = shape.tokens
    mult = 6.0 if shape.kind == "train" else 2.0   # fwd+bwd vs fwd only
    return mult * n * d


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # counted FLOPs (op_cost), one card
    hlo_bytes: float              # counted bytes
    collective_bytes: float       # 0 on one card
    collectives: dict = field(default_factory=dict)   # kind -> counts
    batch_shards: int = 1         # the ranks a batch is split over
    model_flops_total: float = 0.0
    bytes_per_device: float = 0.0  # argument + output + peak live bytes
    transcendentals: float = 0.0
    peak_live_bytes: float = 0.0   # op_cost's peak of the run's allocations
    by_scope: dict = field(default_factory=dict)
    by_op: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / HW.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HW.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / HW.ICI_BW

    @property
    def t_roofline(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs × chips)."""
        total = self.hlo_flops * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput achievable at the dominant-term time,
        as a fraction of peak: (MODEL_FLOPS / chips / t_dominant) / peak."""
        t = self.t_roofline
        if t <= 0:
            return 0.0
        return (self.model_flops_total / self.chips / t) / HW.PEAK_FLOPS_BF16

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, t_roofline=self.t_roofline,
                 bottleneck=self.bottleneck,
                 useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def flash_kernel_bytes(cfg: ArchConfig, shape: Shape,
                       chips: int) -> float:
    """Analytic HBM traffic of the flash-attention kernel for one step:
    per attention call it reads Q, K, V once and writes O once (scores and
    probabilities stay on chip).  Train steps pay forward (1×) + the
    recompute (1×) + the backward (~2.5×: re-reads Q, K, V, O, dO and
    writes dQ, dK, dV).  Divided by ``chips``, the ranks that split the
    attention's batch."""
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if "attn" in cfg.block_kind(i))
    if n_attn == 0:
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s_q, s_kv = 1, shape.seq_len
    else:
        s_q = s_kv = s
    dtype_bytes = 2  # bf16
    per_call = dtype_bytes * (
        2 * b * s_q * cfg.num_heads * cfg.hd          # Q read + O write
        + 2 * b * s_kv * cfg.num_kv_heads * cfg.hd)   # K + V read
    mult = 4.5 if shape.kind == "train" else 1.0
    return mult * per_call * n_attn / chips


def kernel_adjusted_terms(rec: dict, cfg: ArchConfig, shape: Shape) -> dict:
    """Roofline terms with the plain attention's score traffic replaced by
    the flash kernel's analytic traffic."""
    scopes = rec.get("by_scope", {})
    removed = sum(scopes.get(s, {}).get("bytes", 0.0)
                  for s in ("attn_scores", "attn_pv"))
    added = flash_kernel_bytes(cfg, shape, rec.get("batch_shards", 1))
    adj_bytes = rec["hlo_bytes"] - removed + added
    t_mem = adj_bytes / HW.HBM_BW
    t_cmp = rec["hlo_flops"] / HW.PEAK_FLOPS_BF16
    t_col = rec["collective_bytes"] / HW.ICI_BW
    t_dom = max(t_mem, t_cmp, t_col)
    frac = ((rec["model_flops_total"] / rec["chips"] / t_dom)
            / HW.PEAK_FLOPS_BF16 if t_dom > 0 else 0.0)
    return {
        "removed_attn_bytes": removed,
        "flash_kernel_bytes": added,
        "hlo_bytes_adjusted": adj_bytes,
        "t_memory": t_mem, "t_compute": t_cmp, "t_collective": t_col,
        "bottleneck": max((("memory", t_mem), ("compute", t_cmp),
                           ("collective", t_col)), key=lambda kv: kv[1])[0],
        "roofline_fraction": frac,
    }


def analyze_step(fn, args, cfg: ArchConfig, shape: Shape,
                 kwargs=None, *, mesh: str = MESH, chips: int = 1,
                 batch_shards: int = 1) -> tuple:
    """Run ``fn(*args, **kwargs)`` under the cost counter (the
    counterpart of the reference's ``analyze_compiled``); returns
    ``(RooflineReport, fn's result)``.  On a mesh, ``fn`` is one rank's
    share: ``mesh`` names it, ``chips`` is its size and ``batch_shards``
    the ranks its batch is split over."""
    with CostCounter() as counter:
        out = fn(*args, **(kwargs or {}))
    c = counter.cost
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh, chips=chips,
        hlo_flops=c.flops, hlo_bytes=c.bytes_accessed,
        collective_bytes=c.collective_bytes, collectives=c.collectives,
        batch_shards=batch_shards,
        model_flops_total=model_flops(cfg, shape),
        transcendentals=c.transcendentals,
        peak_live_bytes=c.peak_live_bytes,
        by_scope=c.by_scope, by_op=c.by_op), out
