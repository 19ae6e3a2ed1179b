"""The engine's prefill rate: the window's prompt tokens over the sum of
its ``Engine.timings["prefill_s"]`` spans (each a prefill, its cache splice
and its logits' copy to the host)."""


def read(run):
    if run.kind != "serve" or not run.window.get("prefill_s"):
        return None
    return sum(run.window["prefills"]) / run.window["prefill_s"]
