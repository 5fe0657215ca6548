"""The run's whole set-up, from the process's start to the window's:
interpreter and CUDA start, kernel libraries loaded or built, inputs
drawn, matcher built and planned, corpus uploaded, every shape warmed."""


def read(run):
    return run.setup_s
