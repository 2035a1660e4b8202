"""The yardstick's arithmetic, frozen with the benchmark: the chip's peaks
and the operations and bytes that the model and the exchange need, worked
out from the shapes alone (never from a kernel's name or what it runs)."""
