"""Data pipeline: synthetic click-log simulation, out-of-core session store,
and sharded, resumable in-memory + streaming loading (port of
``repro.data``)."""
from repro_torch.data.loader import (ClickLogLoader, DevicePrefetcher,
                                     LoaderState, split_sessions)
from repro_torch.data.store import (SessionStore, SessionStoreWriter,
                                    ShardCorruptionError,
                                    write_session_store)
# the package-level ingest_synthetic is the worker-aware entrypoint
# (workers=1 == the serial reference implementation in data.store)
from repro_torch.data.ingest import ingest_chunks, ingest_synthetic
from repro_torch.data.streaming import (StreamingClickLogLoader,
                                        StreamingLoaderState)
from repro_torch.data.synthetic import (SyntheticConfig, generate_click_log,
                                        iter_click_log_chunks, make_features,
                                        synthesize_chunk)

__all__ = [
    "SyntheticConfig",
    "generate_click_log",
    "iter_click_log_chunks",
    "synthesize_chunk",
    "make_features",
    "ClickLogLoader",
    "DevicePrefetcher",
    "LoaderState",
    "split_sessions",
    "SessionStore",
    "SessionStoreWriter",
    "ShardCorruptionError",
    "write_session_store",
    "ingest_synthetic",
    "ingest_chunks",
    "StreamingClickLogLoader",
    "StreamingLoaderState",
]
