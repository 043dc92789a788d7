"""The port's user scripts (counterparts of the JAX package's ``scripts/``):
``python -m gddim_torch.scripts.sweep`` and
``python -m gddim_torch.scripts.check_int8_fidelity``."""
