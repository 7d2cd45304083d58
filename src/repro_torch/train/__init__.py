"""Training runtime of the slice: the chunked engine and the Trainer."""
from repro_torch.train.engine import TrainEngine
from repro_torch.train.trainer import Trainer, default_metrics

__all__ = ["TrainEngine", "Trainer", "default_metrics"]
