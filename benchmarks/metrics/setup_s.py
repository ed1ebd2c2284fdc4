"""Seconds from the process's start to the window's start: the scene's
build, the kernels' build and load, the warm-up."""


def read(run):
    return run.setup_s
