"""``repro_torch.quant`` — int8/int4 weight and KV quantization, the port of
``repro.quant``.

The storage format (:class:`QTensor`), the offline converters
(:func:`quantize_tree`) and the KV-cache quantizer (:func:`quantize_kv`).
The compute side lives in ``repro_torch.ops.impls`` as the ``eager_int8``
implementations, selected by ``ops.policy_named("eager_int8")``; the
paging side in ``serve/expert_cache.py``, which pages packed expert
weights.
"""

from repro_torch.quant.qtensor import (QTensor, QUANT_PARAM_NAMES,
                                       dequantize, dequantize_tree,
                                       is_qtensor, quantize, quantize_kv,
                                       quantize_tree, tree_bytes)

__all__ = [
    "QTensor", "QUANT_PARAM_NAMES", "dequantize", "dequantize_tree",
    "is_qtensor", "quantize", "quantize_kv", "quantize_tree", "tree_bytes",
]
