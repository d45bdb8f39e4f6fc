"""PyTorch + CUDA port of lzani-tpu for NVIDIA Hopper (H100).

The JAX package ``lzani_tpu`` stays the reference. This package stands
alone: it keeps its own copies of the host layer (params, FASTA/kmer-db
ingest, output writers, the native C++ engine and its event-log replay,
the matcher and CLI; tests hold them equal to the originals) and
replaces the device engine: plain PyTorch tensor prep on an explicit
``torch.device`` and hand-written CUDA event-log parse kernels
(``csrc/parse_events.cu``). It imports neither jax nor ``lzani_tpu``.

Entry point: ``python -m lzani_tpu_torch all2all ...`` (``--backend auto`` =
``hybrid``; ``cuda``, ``native``).
"""

__version__ = "0.1.0"
VERSION_STRING = "lz-ani-torch 0.1.0"
