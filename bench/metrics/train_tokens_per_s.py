"""Training throughput: the tokens of every step the window ran, over the
window's seconds (its last step waited for)."""


def read(run):
    if run.kind != "train" or not run.window.get("steps"):
        return None
    return run.window["tokens"] / run.window["seconds"]
