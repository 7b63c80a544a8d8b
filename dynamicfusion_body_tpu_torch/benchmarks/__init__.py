"""The port's benchmark entry points: ``bench`` (the frame bench with its
three accuracy gates, BASELINE config 5) and ``suite`` (BASELINE configs
1-7), the counterparts of the repository's ``bench.py`` and
``benchmarks/suite.py``."""
