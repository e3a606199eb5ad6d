"""plan_setup_s: the benchmark's span around the calls that build the
cell's plans in set-up (host clock)."""

from hebench.readers import span_s


def read(run):
    return span_s(run, "plan_setup")
