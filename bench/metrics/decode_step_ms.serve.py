"""The engine's decode step: the window's ``Engine.timings["decode_s"]``
spans (each a decode step of every slot and its logits' copy to the
host), their mean in milliseconds."""


def read(run):
    if run.kind != "serve" or not run.window.get("decode_s"):
        return None
    d = run.window["decode_s"]
    return 1e3 * sum(d) / len(d)
