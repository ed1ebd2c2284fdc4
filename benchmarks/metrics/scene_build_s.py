"""Seconds of the program's scene constructor (the Simulator's or the
differentiable scene's: the cluster build and the device tables), timed by
the benchmark around the call."""


def read(run):
    return run.scene_build_s
