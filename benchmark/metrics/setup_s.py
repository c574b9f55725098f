"""setup_s: seconds from the process's start to the window's: imports,
the key and witnesses made from the seed, the entry's set-up (a Prover,
or the files), the warm-up ops, and in a checkout's first run the kernel
builds."""


def read(run):
    return run.setup_s
