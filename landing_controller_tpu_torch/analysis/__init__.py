"""Analysis subsystems: NLP-vs-NN validation, the warm-start timing
comparison harness, touchdown foot-position envelopes
(``analysis.foot_positions``).  The tracking value function
(``analysis/vbl.py`` of the JAX package) is not ported yet."""

from .nn_validation import nn_vs_nlp, plot_nn_overlay
from .warmstart_bench import plot_warmstart_comparison, warmstart_comparison

__all__ = [
    "nn_vs_nlp",
    "plot_nn_overlay",
    "plot_warmstart_comparison",
    "warmstart_comparison",
]
