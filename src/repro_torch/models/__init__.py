"""Model families beyond the click models (port of ``repro.models``): so
far the tabular recsys models."""
