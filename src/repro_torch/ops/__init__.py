"""``repro_torch.ops`` — the compute-dispatch seam between models and kernels
(the port of ``repro.ops``)::

    from repro_torch import ops

    with ops.use_policy(ops.policy_named("cuda")):
        y = model(images, task="semseg")
    print(ops.dispatch_report())
"""

from repro_torch.ops.policy import (ComputePolicy, DEFAULT_POLICY, OPS,
                                    current_policy, policy_named, use_policy)
from repro_torch.ops.registry import (DispatchError, collective_report,
                                      dispatch, dispatch_report, register,
                                      reset_dispatch_report)


def apply_activation(x, kind):
    """Policy-dispatched activation; ``None``/"none"/"identity" is a free
    pass-through (no dispatch record)."""
    if kind in (None, "none", "identity"):
        return x
    return dispatch("activation", x, kind=kind)


__all__ = [
    "ComputePolicy", "DEFAULT_POLICY", "OPS",
    "current_policy", "policy_named", "use_policy",
    "DispatchError", "dispatch", "dispatch_report", "register",
    "reset_dispatch_report", "collective_report", "apply_activation",
]
