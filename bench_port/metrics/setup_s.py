"""From process start to the first timed frame (s): imports, the CUDA
context, the kernels' build or load, input generation, the scene build
(IBL precompute, atlases), placement on the cards and warm-up."""


def read(run):
    return run["setup_s"]
