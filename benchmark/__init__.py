"""The benchmark of the PyTorch and CUDA port ``lzani_tpu_torch``: whole
all-vs-all jobs, timed, and checked against a plain reference. See
``benchmark/README.md``."""
