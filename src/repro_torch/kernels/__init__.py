"""The port's hand-written Hopper kernels, one module each, beside their
plain PyTorch versions.

Each public wrapper counts its launches in an integer attribute
``launches`` that it increments only where it launches its kernel; a run
reads :func:`launch_counts` to show that the main path went through the
kernels.
"""

from repro_torch.kernels import decode_fused, flash_attention, gelu_lut, \
    moe_fused, moe_gemm, unified_linear

#: kernel name -> public wrapper
KERNELS = {
    "unified_linear": unified_linear.unified_linear,
    "flash_attention": flash_attention.flash_attention,
    "gelu_lut": gelu_lut.lut_activation,
    "moe_gemm": moe_gemm.moe_gemm,
    "moe_fused": moe_fused.fused_moe_ffn,
    "decode_fused": decode_fused.fused_decode_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def variant_counts() -> dict[str, dict[str, int]]:
    return {name: dict(fn.variants) for name, fn in KERNELS.items()
            if hasattr(fn, "variants")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for v in getattr(fn, "variants", {}):
            fn.variants[v] = 0


__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "variant_counts"]
