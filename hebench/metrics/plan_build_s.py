"""plan_build_s: the program's own seconds building plans
(`hexl_tpu_torch.ntt.plan.cache_stats["build_s"]`: plans, stacked plans,
their device tables and row descriptors), read at the end of the run. A
run's calls find every plan built in set-up and warm-up, so this is the
building of set-up unless the run's `misses` grew after it. Nothing where
the program keeps no such counter."""


def read(run):
    from hexl_tpu_torch.ntt import plan

    stats = getattr(plan, "cache_stats", None)
    if stats is None:
        return None
    return stats["build_s"]
