"""launches_per_op.mult: the program's kernel launches
(`hexl_tpu_torch._build.launches`) in the window per operation."""

from hebench.readers import launches_per_op as read  # noqa: F401
