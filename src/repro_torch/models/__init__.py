"""Model families beyond the click models (port of ``repro.models``): the
recsys models, GraphSAGE (``models/gnn``) and the LM family
(``models/lm``)."""
