"""``setup_s``: seconds from the process's start to the end of the
warm-up (imports, the CUDA context, the kernels' build or load, the
inputs and the warm-up at the cell's own shapes)."""


def read(r):
    return r.setup_s
