"""One module per traffic ``driver`` kind: ``run(cell, seed, seconds, trace, device, ...)``."""
