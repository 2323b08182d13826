"""Deterministic synthetic data streams, the port of ``repro.data``."""

from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       SyntheticM3ViTStream, device_transform,
                                       make_stream, prefetch, shard_for)

__all__ = ["DataConfig", "SyntheticLMStream", "SyntheticM3ViTStream",
           "make_stream", "prefetch", "device_transform",
           "shard_for"]
