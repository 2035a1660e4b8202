"""idle_pct: the share of a step's wall in which no kernel, memcpy or
memset ran on the device. The device's busy time a step comes from the
profiled steps; the step's wall from the untraced window of the same
run, since the profiler's own host cost stretches the profiled steps'
wall. On a mesh the largest over the ranks."""


def read(rec: dict):
    return max(100.0 * (1.0 - r["busy_s"] / r["steps"] / r["untraced_step_s"])
               for r in rec["ranks"])
