"""step_graph.capture_s: the seconds the program's capture of the cell's
pass or training step took (utils/step_graph.py Pass.capture_s /
GradStep.capture_s: warm-up, capture, instantiation)."""


def read(run):
    return run.capture_s
