"""The benchmark's yardstick: what later changes to the program may not
change. The traffic generator (``synthetic``), the weights (``weights``),
the arithmetic of bytes, operations and peaks (``cost``), the reduction of
a profiler trace (``trace``) and the comparison with the plain reference
that decides ``correct`` (``check``)."""
