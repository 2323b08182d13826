"""The routed expert FFN's roofline share in the traced stretch: the bound
of the top-k rows' products (each expert's weights read once a layer) over
the device time of the kernels that do it: ``moe_fused``, or ``moe_gemm``
with the LUT activation on the staged path."""

from ebench.shares import roofline


def read(run):
    return roofline(run, "moe_ffn",
                    ["moe_fused", "moe_gemm", "lut_activation"])
