"""Model building blocks and the M³ViT model (the port of ``repro.models``
for the vit-moe family)."""
