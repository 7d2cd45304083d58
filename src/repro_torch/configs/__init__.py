"""Model configurations (port of ``repro.configs``: ``clax_baidu``,
``deepfm``, ``autoint`` and the recsys ``SHAPES``)."""
