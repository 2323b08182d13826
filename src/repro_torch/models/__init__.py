"""Model building blocks, the M³ViT model and the decoder-LM facade (the
port of ``repro.models`` for the vit-moe family and the attention LMs)."""
