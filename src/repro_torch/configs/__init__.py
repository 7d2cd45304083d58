"""Model configurations (port of ``repro.configs.clax_baidu``)."""
