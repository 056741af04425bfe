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
- ``cascade_sweep``: which stage-1 blocks help the kinodynamic stage.

Each runs on the card unless given ``--device cpu`` and raises without one;
``--out`` names the record it writes (JSON).
"""
