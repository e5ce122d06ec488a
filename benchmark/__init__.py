"""The port's benchmark: run ``python3 benchmark/run.py --help``."""
