"""Data pipeline of the training slice: synthetic click logs, the in-memory
loader and the device prefetcher."""
from repro_torch.data.loader import (ClickLogLoader, DevicePrefetcher,
                                     LoaderState, split_sessions)
from repro_torch.data.synthetic import (SyntheticConfig, generate_click_log,
                                        make_features)

__all__ = [
    "ClickLogLoader", "DevicePrefetcher", "LoaderState", "split_sessions",
    "SyntheticConfig", "generate_click_log", "make_features",
]
