"""Reference of ``configs/kinodynamic_factory.json``: the production
kinodynamic NLP (landing_optimization.m:39-201) with its reference cold
guess and network retry; see :mod:`.landing`."""

import os

from benchmarks.harness import ROOT
from benchmarks.reference.landing import Reference


def make(cfg, device, precision="float64"):
    return Reference(cfg, os.path.join(ROOT, cfg["nn_path"]), device, precision)
