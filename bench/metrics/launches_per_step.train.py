"""The program's kernel launches (``ops.launches``, every kernel) per
training step of the window."""


def read(run):
    if run.kind != "train" or not run.window.get("launches"):
        return None
    return run.window["launches"] / run.window["steps"]
