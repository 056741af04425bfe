"""Example programs, run as ``python -m landing_controller_tpu_torch.examples.<name>``."""
