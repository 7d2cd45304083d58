"""The recsys shapes (port of ``SHAPES`` of ``repro.configs.recsys_common``;
``build_recsys_cell``, a sharded ahead-of-time construct, waits for
``launch/dryrun.py``)."""

SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}
