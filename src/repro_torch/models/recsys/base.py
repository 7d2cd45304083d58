"""What the recsys models share around their ``forward``: the loss,
serving and the train step (the methods each JAX model repeats), and the
tabular models' retrieval scoring."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import optim as optim_lib
from repro_torch.nn.module import Module
from repro_torch.stable import log_bce, log_sigmoid


def make_generator(device, seed: int) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``; None on ``meta``,
    where the initializers draw nothing."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


class RecsysModel(Module):
    """A click-probability model over a batch dict; subclasses define
    ``forward(batch, mesh=None) -> (B,) logits``. The default
    ``retrieval_score`` is the tabular models' (DeepFM, AutoInt); BST and
    MIND define their own.

    **On a mesh** (JAX's ``param_specs`` and its cells'
    ``in_shardings``): the tables named in ``TABLES`` are row-sharded over
    ``model`` (:meth:`place_` keeps this rank's rows), everything else is
    replicated. Each rank runs its rows of the batch (split over the data
    axes); the lookups sum the rows each model rank owns over ``model``,
    so what follows them is replicated there. The train step takes each
    rank's share of the global mean loss, sums every gradient over the
    data axes (the table shards' too: each data rank's rows reach them)
    and updates the shards and the towers in place, one ``adamw`` launch a
    tensor on the card.
    """

    #: The ParameterDicts that hold the model's row-sharded tables.
    TABLES = ("embedding",)

    def param_specs(self, mesh=None):
        """The JAX tree of :class:`~repro_torch.distrib.shardings.P`: each
        table's tensors ``P("model", None)``, every other leaf ``P()``."""
        from repro_torch.convert import param_path
        from repro_torch.distrib.shardings import P
        from repro_torch.tree import nest

        del mesh
        paths = [param_path(n) for n, _ in self.named_parameters()]
        return nest(paths, [P("model", None) if path[0] in self.TABLES
                            else P() for path in paths])

    def place_(self, mesh) -> "RecsysModel":
        """Keep this rank's rows of every table (a copy of the block; on
        ``meta`` only its shape). Raises unless ``model`` divides each
        table's rows."""
        from repro_torch.distrib.shardings import NamedSharding, P

        for name in self.TABLES:
            tables = getattr(self, name)
            for key, t in list(tables.items()):
                block = NamedSharding(mesh, P("model", None)).local(
                    t.detach())
                tables[key] = torch.nn.Parameter(block.clone())
        return self

    def loss(self, batch, mesh=None) -> torch.Tensor:
        log_p = log_sigmoid(self.forward(batch, mesh))
        return torch.mean(log_bce(log_p, batch["labels"]))

    def make_train_step(self, optimizer=None, mesh=None):
        """``step(opt_state, batch) -> (opt_state, loss)``, starting from
        ``step.init()``.

        Unlike the JAX step, which returns new params, this one updates the
        module's parameters (and the Adam moments) in place: at full width
        the tables hold 0.6-1.3B floats, and one copy of each is kept. On
        the card the update is ``optim.step``'s fused pass (one ``adamw``
        launch per tensor). The loss comes back as a device tensor, so the
        step does not sync.

        With ``mesh`` (the model :meth:`place_`-d on it) the batch is this
        rank's rows and the loss the global batch's mean: each rank's mean
        over its rows divided by the data axes' size, its gradients summed
        over those axes.
        """
        optimizer = optimizer or optim_lib.adamw(1e-3)
        params = list(self.parameters())
        group, share = None, 1
        if mesh is not None:
            from repro_torch.distrib.collectives import axes_group
            from repro_torch.distrib.shardings import (DATA_AXES,
                                                       data_parallel_size)

            group = axes_group(mesh, DATA_AXES(mesh))
            share = data_parallel_size(mesh)

        def step(opt_state, batch):
            loss = self.loss(batch, mesh)
            if group is not None:
                loss = loss / share
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
            if group is not None:
                import torch.distributed as dist

                for t in (loss,) + grads:
                    dist.all_reduce(t, group=group)
            opt_state = optim_lib.step(optimizer, grads, opt_state, params)
            return opt_state, loss

        step.init = lambda: optimizer.init(params)
        return step

    def serve(self, batch, mesh=None) -> torch.Tensor:
        """Click log-probabilities for a request batch (this rank's rows on
        a mesh)."""
        return log_sigmoid(self.forward(batch, mesh))

    def retrieval_score(self, batch, mesh=None) -> torch.Tensor:
        """One batched forward over the candidate-expanded field matrix
        (1M candidate rows in one call, never a host loop; this rank's
        rows on a mesh)."""
        return self.forward(batch, mesh)
