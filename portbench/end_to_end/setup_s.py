"""Process start to the first timed call: imports, CUDA context, frames,
the kernel library (built on a checkout's first run), runner and
warm-up."""


def read(run):
    return run.setup_s
