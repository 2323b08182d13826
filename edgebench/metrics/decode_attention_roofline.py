"""Decode attention's roofline share in the traced stretch: the bound of
reading each live lane's cached K and V rows once a layer over the device
time of ``decode_fused``."""

from ebench.shares import roofline


def read(run):
    return roofline(run, "decode_attention", ["decode_fused"])
