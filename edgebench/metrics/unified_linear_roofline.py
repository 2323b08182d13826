"""``unified_linear``'s roofline share in the traced stretch: the summed
bound of the products it ran (M³ViT: patch embedding, attention
projections, dense MLPs, head; decoders: prefill rows, decode lanes, the
head) over the device time of its kernels."""

from ebench.shares import roofline


def read(run):
    return roofline(run, "unified_linear", ["unified_linear"])
