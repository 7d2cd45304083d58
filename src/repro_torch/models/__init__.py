"""Model families beyond the click models (port of ``repro.models``): so
far the recsys models (``models/gnn`` and ``models/lm`` wait)."""
