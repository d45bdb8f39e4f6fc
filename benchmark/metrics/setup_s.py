"""setup_s: from the start of the benchmark's process to the start of the
window: imports, the CUDA context, the kernels' and the native engine's
libraries, the generated collections written as FASTA, and the warm
job."""


def read(run):
    return run.setup_s
