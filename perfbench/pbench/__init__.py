"""The harness of the benchmark: the program driven through its API, the
plain reference, the comparison that decides ``correct`` and the trace
reduction (``perfbench/README.md``)."""
