"""The benchmark's general code: the manifest, the device, the frozen
operation and byte counts, the data made from the seed, the profiled
slice and its checks, and the run itself (core.py)."""
