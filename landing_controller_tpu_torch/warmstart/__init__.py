"""Warm-start layer: reference and ballistic cold guesses, the learned NN
warm start, the SRBM -> kinodynamic cascade and receding-horizon replanning.

``cascade`` and ``replan`` build solvers of :mod:`..api`; import them from
their modules (``warmstart.cascade``, ``warmstart.replan``)."""
