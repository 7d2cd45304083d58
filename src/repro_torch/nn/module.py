"""Base module of the port's parameterizations and click models.

``repro.nn.module.Module`` is structure only: parameters live in a pytree
built by ``init(rng)``. Here a module owns its parameters as a
``torch.nn.Module`` does, and each parameter keeps the leaf name of the JAX
tree (``table``, ``baseline``, ``value``), so a JAX ``init`` tree maps onto
``named_parameters()`` path by path (see ``repro_torch.convert``).
"""
from __future__ import annotations

import torch


class Module(torch.nn.Module):
    def n_params(self) -> int:
        """Number of scalar parameters."""
        return int(sum(p.numel() for p in self.parameters()))
