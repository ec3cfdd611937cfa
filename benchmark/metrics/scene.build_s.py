"""scene.build_s: the harness's host clock around building the cell's
scene for the program: the configuration's arrays, the program's
constructors and scene/build.py attach_accelerator."""


def read(run):
    return run.build_s
