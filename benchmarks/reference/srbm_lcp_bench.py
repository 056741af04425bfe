"""Reference of ``configs/srbm_lcp_bench.json``: the srbm_lcp NLP
(generate_landingCtrller_IPOPT_warmstart.m:41-170) with the production dt
schedule, ballistic cold guess and network retry; see :mod:`.landing`."""

import os

from benchmarks.harness import ROOT
from benchmarks.reference.landing import Reference


def make(cfg, device, precision="float64"):
    return Reference(cfg, os.path.join(ROOT, cfg["nn_path"]), device, precision)
