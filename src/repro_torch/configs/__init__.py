"""Model configurations (port of ``repro.configs``: ``clax_baidu``,
``deepfm``, ``autoint``, ``bst``, ``mind``, the recsys ``SHAPES`` and
batch factories, and the ``registry``; the LM and GNN configs wait)."""
