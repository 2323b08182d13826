from repro_torch.configs.base import ArchConfig, MoESpec, get, reduced

__all__ = ["ArchConfig", "MoESpec", "get", "reduced"]
