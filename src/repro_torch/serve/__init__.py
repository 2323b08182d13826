"""Serving (the port of ``repro.serve``): the all-resident M³ViT server."""
