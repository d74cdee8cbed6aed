"""Seconds of set-up: importing the port, building the seed's blocks,
loading and building the kernels, and warming every shape the window uses."""


def read(run):
    return run.setup_s
