"""Set-up: seconds from the process's start to the first timed request
(imports, the CUDA context, the weights, the batcher, the cell's warm-up)."""


def read(run):
    return run.setup_s
