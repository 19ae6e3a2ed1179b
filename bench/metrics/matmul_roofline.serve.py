"""The matmul kernel's share of its roofline in the traced serving steps:
the least time of the traced prefills' and decode steps' products (a
decode step's expert products read every expert's weights; ``bench/cost``)
over the device time of the program's matmul kernels."""

from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "serve" or run.trace is None \
            or not run.trace.kernel_s.get("matmul"):
        return None
    need = sum(W.prefill_matmul(run.spec, n).bound_s
               for n in run.traced["prefills"]) \
        + sum(W.decode_matmul(run.spec, r).bound_s
              for r in run.traced["decode_rows"] if r)
    return 100 * need / run.trace.kernel_s["matmul"]
