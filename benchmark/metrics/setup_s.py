"""setup_s: seconds from the process's start to the window's start: imports,
the card's context, the kernel library (built on a checkout's first run,
loaded after), the inputs, the graph's recording and the warm-up calls."""


def read(run):
    return run.setup_s
