"""Module base and initializers (port of the parts of ``repro.nn`` that the
click models use)."""
from repro_torch.nn import init
from repro_torch.nn.module import Module

__all__ = ["Module", "init"]
