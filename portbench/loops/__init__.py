"""The loops that run the traffic mixes, one module per ``loop`` a mix names.
Each gives ``run(cell, seed, seconds, trace, device, builder, t_process)
-> Outcome``."""
