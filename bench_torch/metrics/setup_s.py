"""setup_s: seconds from the process's start to the first measured window:
imports, the recording's synthesis, the decoder's build (the kernels load
from the port's build cache, or build on a checkout's first run) and the
driver's warm-up on the stream's first windows. Host clock."""


def read(run):
    return run.setup_s
