"""Command-line entry points (the port of ``repro.launch``): ``serve``."""
