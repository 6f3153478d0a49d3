"""Hand-written Pallas kernels for the hot intersection stages (GPU)."""
