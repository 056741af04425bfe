"""Analysis subsystems: the tracking value function (VBL / Riccati),
NLP-vs-NN validation, the warm-start timing comparison harness, touchdown
foot-position envelopes (``analysis.foot_positions``)."""

from .nn_validation import nn_vs_nlp, plot_nn_overlay
from .vbl import (default_vbl_weights, riccati_step_backward, riccati_step_forward,
                  riccati_value_function, variational_dynamics)
from .warmstart_bench import plot_warmstart_comparison, warmstart_comparison

__all__ = [
    "nn_vs_nlp",
    "plot_nn_overlay",
    "variational_dynamics",
    "riccati_step_backward",
    "riccati_step_forward",
    "riccati_value_function",
    "default_vbl_weights",
    "warmstart_comparison",
    "plot_warmstart_comparison",
]
