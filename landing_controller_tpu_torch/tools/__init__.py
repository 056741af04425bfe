"""The programs that make the port's records, one module each, run as
``python -m landing_controller_tpu_torch.tools.<name>`` (the counterparts of
the JAX package's ``tools/*.py`` of the same names):

- ``montecarlo_100k``: chunked streaming Monte-Carlo record with the
  success-region map over (pitch, v_z);
- ``train_warmstart``: streaming kinodynamic factory, normalisation,
  training, the saved network and the four-regime comparison, behind two
  gates;
- ``warmstart_compare``: the four-regime comparison on a saved network;
- ``eeparam_bench``: batched ``EEParamSolver`` throughput;
- ``kino_battery``: single-knob responses of cold kinodynamic solves;
- ``cascade_sweep``: which stage-1 blocks help the kinodynamic stage;
- the convergence diagnostics of the srbm_lcp solver: ``conv_battery``
  (convergence and iterations by barrier rule and budget),
  ``fail_taxonomy`` (the constraint group that pins each failed lane),
  ``diag_conv`` (the KKT, barrier and step histories of failed lanes),
  ``iter_bench`` (ms per batch iteration by setting) and ``tune_sweep``
  (converged solves/s by setting and batch size).

Each runs on the card unless given ``--device cpu`` and raises without one;
``--out`` names the record it writes (JSON).
"""
