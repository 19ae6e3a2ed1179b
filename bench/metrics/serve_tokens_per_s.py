"""Serving throughput: prompt and generated tokens of the requests that
completed in the window, over the window's seconds."""


def read(run):
    if run.kind != "serve" or not run.window.get("completed"):
        return None
    return run.window["served"] / run.window["seconds"]
