"""Model configurations (port of ``repro.configs``: ``clax_baidu``, the
recsys configs (``deepfm``, ``autoint``, ``bst``, ``mind``, the recsys
``SHAPES`` and batch factories), ``graphsage_reddit``, the LM configs
(``lm_common`` and the five archs) and the ``registry``)."""
