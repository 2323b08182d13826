"""Serving (the port of ``repro.serve``): the all-resident M³ViT server
and the LM serving engine."""
