"""Per-ray math: intersection, shading, vector helpers, RNG, GPU sweep kernel."""
