"""What the recsys models share around their ``forward``: the loss,
serving and the train step (the methods each JAX model repeats), and the
tabular models' retrieval scoring."""
from __future__ import annotations

import torch

from repro_torch import optim as optim_lib
from repro_torch.nn.module import Module
from repro_torch.stable import log_bce, log_sigmoid


def make_generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


class RecsysModel(Module):
    """A click-probability model over a batch dict; subclasses define
    ``forward(batch) -> (B,) logits``. The default ``retrieval_score`` is
    the tabular models' (DeepFM, AutoInt); BST and MIND define their own."""

    def loss(self, batch) -> torch.Tensor:
        log_p = log_sigmoid(self.forward(batch))
        return torch.mean(log_bce(log_p, batch["labels"]))

    def make_train_step(self, optimizer=None):
        """``step(opt_state, batch) -> (opt_state, loss)``, starting from
        ``step.init()``.

        Unlike the JAX step, which returns new params, this one updates the
        module's parameters (and the Adam moments) in place: at full width
        the tables hold 0.6-1.3B floats, and one copy of each is kept. On
        the card the update is ``optim.step``'s fused pass (one ``adamw``
        launch per tensor). The loss comes back as a device tensor, so the
        step does not sync.
        """
        optimizer = optimizer or optim_lib.adamw(1e-3)
        params = list(self.parameters())

        def step(opt_state, batch):
            loss = self.loss(batch)
            grads = torch.autograd.grad(loss, params)
            opt_state = optim_lib.step(optimizer, grads, opt_state, params)
            return opt_state, loss.detach()

        step.init = lambda: optimizer.init(params)
        return step

    def serve(self, batch) -> torch.Tensor:
        """Click log-probabilities for a request batch."""
        return log_sigmoid(self.forward(batch))

    def retrieval_score(self, batch) -> torch.Tensor:
        """One batched forward over the candidate-expanded field matrix
        (1M candidate rows in one call, never a host loop)."""
        return self.forward(batch)
