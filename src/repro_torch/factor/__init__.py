"""``repro_torch.factor`` — factored experts (shared basis + per-expert
delta), the port of ``repro.factor``.

The storage format (:class:`FactoredTensor`: dense shared basis + low-rank
or Monarch-butterfly per-expert delta, optionally int8/int4) and the
SVD-seeded offline converters (:func:`factorize`,
:func:`factorize_tree`).  The compute side lives in
``repro_torch.ops.impls`` as the ``eager_factored`` implementations,
selected by ``ops.policy_named("eager_factored")``; the paging side in
``serve/expert_cache.py``, which pins the basis on the device and pages
only the delta leaves.
"""

from repro_torch.factor.factored import (FACTOR_PARAM_NAMES, FactoredTensor,
                                         factored_linear, factored_moe_gemm,
                                         factorize, factorize_tree,
                                         is_factored, reconstruct,
                                         reconstruct_tree, split_dim)

__all__ = [
    "FACTOR_PARAM_NAMES", "FactoredTensor", "factored_linear",
    "factored_moe_gemm", "factorize", "factorize_tree", "is_factored",
    "reconstruct", "reconstruct_tree", "split_dim",
]
