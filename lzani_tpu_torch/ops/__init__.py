"""Device engine of the port: torch prep, the CUDA kernels (the
event-log parse and the fold of a log into its stats) with their plain
PyTorch versions, the all-vs-all loops of the cuda, hybrid and jax
backends and the replay finalizer."""
