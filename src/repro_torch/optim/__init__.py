"""AdamW over flat dotted-name parameter dicts, the port of
``repro.optim``."""

from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
