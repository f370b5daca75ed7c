"""Seconds from the start of the process to the end of set-up: imports,
the inputs drawn from the seed, the program's objects, the kernel
build on a checkout's first run, and the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
