"""The paper's techniques in PyTorch: attention, routing, MoE, unified
linear, single-pass softmax and GELU/LUT activations (the port of
``repro.core``)."""
