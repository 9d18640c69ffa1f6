"""setup_s: from the process's start to the window's opening: imports,
the kernels' build (a checkout's first run) and load, the engine, the
seeded frames, and the warm-up applies (first walk and capture)."""


def read(r):
    return r.setup_s
