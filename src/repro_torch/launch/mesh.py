"""The card's roofline constants, the port of ``repro.launch.mesh``.

``HW`` holds one NVIDIA H100 SXM's peak rates (dense, no sparsity), the
counterpart of the reference's TPU v5e constants; ``chip_smoke.py`` and
``roofline/analysis.py`` both read them, so a kernel's bound and a step's
roofline cannot drift apart.  ``HBM_BYTES`` is what
``torch.cuda.get_device_properties(0).total_memory`` reads on an H100
80GB HBM3 (``chip_smoke.py`` phase 9 prints both); the dry-run's "fits"
holds a cell's bytes against it.

``make_production_mesh`` gives the reference's production meshes as
device-free ``dist.spmd.VirtualMesh`` objects — (16, 16) ``("data",
"model")`` and (2, 16, 16) ``("pod", "data", "model")`` — for the
dry-run, which runs rank 0's share of a step on ``meta`` through them.
It never starts a process group.
"""

from __future__ import annotations

__all__ = ["HW", "make_production_mesh"]


class HW:
    """H100 SXM roofline constants (one card)."""

    PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense tensor-core bf16
    PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 outside the tensor cores
    HBM_BW = 3.35e12                # bytes/s, HBM3
    NVLINK_BW = 450e9               # bytes/s a direction (NVLink 4)
    ICI_BW = NVLINK_BW              # the reference's name for the link rate
    HBM_BYTES = 85_017_493_504      # the H100 80GB HBM3's total_memory


def make_production_mesh(*, multi_pod: bool = False):
    """The single-pod (16, 16) or multi-pod (2, 16, 16) mesh, device-free."""
    from repro_torch.dist.spmd import VirtualMesh

    if multi_pod:
        return VirtualMesh((2, 16, 16), ("pod", "data", "model"))
    return VirtualMesh((16, 16), ("data", "model"))
