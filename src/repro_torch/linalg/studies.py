"""The paper's four tuning studies (§V.C), at two scales.

- ``paper`` scale reproduces the exact configuration spaces of §V.C
  (matrix sizes, block/tile grids, processor counts 256-4096).  Running
  them is possible but slow on this container (hundreds of millions of
  simulated events); the benchmarks default to
- ``ci`` scale: the SAME configuration-space *structure* (same number of
  configurations, same n/b and grid-aspect progressions, same base-case /
  lookahead / inner-blocking alternatives) on a 64-rank machine with
  proportionally reduced matrices.  EXPERIMENTS.md records the mapping.

Capital's study does NOT reset kernel statistics between configurations
(its kernels recur across configurations; eager propagation exploits this —
paper §VI.A/§VI.B); SLATE's and CANDMC's studies reset (§VI.A).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.api.space import SearchSpace
from repro_torch.core.tuner import Configuration, Study, space_of_study
from repro_torch.simmpi.costmodel import KNL_STAMPEDE2

from . import capital_cholesky, slate_cholesky, candmc_qr, slate_qr


def capital_cholesky_study(scale: str = "ci") -> Study:
    if scale == "paper":
        p, c, n, b0 = 512, 8, 16384, 128
    else:
        p, c, n, b0 = 64, 4, 1024, 16
    configs: List[Configuration] = []
    for v in range(15):
        b = b0 * 2 ** (v % 5)
        strategy = (v + 1 + 4) // 5   # ceil((v+1)/5): 1,1,1,1,1,2,...,3
        configs.append(Configuration(
            name=f"capital-b{b}-s{strategy}",
            params={"block": b, "strategy": strategy, "n": n},
            make_program=lambda w, n=n, b=b, s=strategy, c=c:
                capital_cholesky.make_program(w, n=n, block=b, strategy=s,
                                              grid_c=c)))
    return Study(name=f"capital-cholesky-{scale}", world_size=p,
                 configs=configs, reset_between_configs=False,
                 machine=KNL_STAMPEDE2)


def slate_cholesky_study(scale: str = "ci") -> Study:
    if scale == "paper":
        p, pr, pc, n, t0, dt = 1024, 32, 32, 65536, 256, 64
    elif scale == "mid":
        # beyond-Capital paper-scale stepping stone: the §V.C configuration
        # structure on 256 real ranks (the SLATE QR paper geometry) with
        # the matrix scaled so a sweep stays hours-not-days on this
        # container — the artifact recorded by ``bench_paper --scale mid``
        p, pr, pc, n, t0, dt = 256, 16, 16, 16384, 256, 64
    else:
        p, pr, pc, n, t0, dt = 64, 8, 8, 8192, 256, 64
    configs: List[Configuration] = []
    for v in range(20):
        tile = t0 + dt * (v // 2)
        la = v % 2
        configs.append(Configuration(
            name=f"slate-chol-t{tile}-la{la}",
            params={"tile": tile, "lookahead": la, "n": n},
            make_program=lambda w, n=n, t=tile, la=la, pr=pr, pc=pc:
                slate_cholesky.make_program(w, n=n, tile=t, lookahead=la,
                                            pr=pr, pc=pc)))
    return Study(name=f"slate-cholesky-{scale}", world_size=p,
                 configs=configs, reset_between_configs=True,
                 machine=KNL_STAMPEDE2)


def candmc_qr_study(scale: str = "ci") -> Study:
    if scale == "paper":
        p, m, n, b0, g0 = 4096, 131072, 8192, 8, 64
    else:
        p, m, n, b0, g0 = 64, 4096, 512, 8, 8
    configs: List[Configuration] = []
    for v in range(15):
        b = b0 * 2 ** (v % 5)
        pr = g0 * 2 ** (v // 5)
        pc = p // pr
        configs.append(Configuration(
            name=f"candmc-qr-b{b}-g{pr}x{pc}",
            params={"block": b, "pr": pr, "pc": pc, "m": m, "n": n},
            make_program=lambda w, m=m, n=n, b=b, pr=pr, pc=pc:
                candmc_qr.make_program(w, m=m, n=n, block=b, pr=pr, pc=pc)))
    return Study(name=f"candmc-qr-{scale}", world_size=p,
                 configs=configs, reset_between_configs=True,
                 machine=KNL_STAMPEDE2)


def slate_qr_study(scale: str = "ci") -> Study:
    if scale == "paper":
        p, m, n, t0, dt, w0, g0 = 256, 65536, 4096, 256, 64, 8, 64
    else:
        p, m, n, t0, dt, w0, g0 = 64, 4096, 512, 64, 32, 8, 16
    configs: List[Configuration] = []
    for v in range(63):
        w_ = w0 * 2 ** (v % 3)
        tile = t0 + dt * ((v // 3) % 7)
        pr = g0 // 2 ** (v // 21)
        pc = p // pr
        configs.append(Configuration(
            name=f"slate-qr-w{w_}-t{tile}-g{pr}x{pc}",
            params={"inner": w_, "tile": tile, "pr": pr, "pc": pc,
                    "m": m, "n": n},
            make_program=lambda wld, m=m, n=n, t=tile, iw=w_, pr=pr, pc=pc:
                slate_qr.make_program(wld, m=m, n=n, tile=t, inner=iw,
                                      pr=pr, pc=pc)))
    return Study(name=f"slate-qr-{scale}", world_size=p,
                 configs=configs, reset_between_configs=True,
                 machine=KNL_STAMPEDE2)


STUDIES: Dict[str, callable] = {
    "capital-cholesky": capital_cholesky_study,
    "slate-cholesky": slate_cholesky_study,
    "candmc-qr": candmc_qr_study,
    "slate-qr": slate_qr_study,
}


def search_space(name: str, scale: str = "ci", *,
                 max_configs: Optional[int] = None) -> SearchSpace:
    """The session-API view of a paper study: ``search_space
    ("slate-cholesky")`` feeds ``repro.api.AutotuneSession`` with a
    ``SimBackend``.  ``max_configs`` truncates for fast CI passes."""
    return space_of_study(STUDIES[name](scale)).subset(max_configs)
