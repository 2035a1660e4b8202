"""Drivers of the port: the paper's experiment (cnn_dist, time_breakdown,
throughput, convergence, k_sensitivity, comm_complexity) and the card
timers (time_sketch_kernels, time_paths)."""
