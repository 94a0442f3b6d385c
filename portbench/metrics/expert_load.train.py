"""expert_load.train: the busiest held expert's pairs over a held expert's
mean, from the port's counters over the profiled steps (utils/trace.py
count): avt.moe.pairs_max (the largest held expert's (token, choice) pairs,
summed over the MoE layers) over avt.moe.pairs_held (the pairs routed to
any held expert, summed alike) / the held experts; 1 is an even load.
Nothing for a family without counters or a program without these."""


def read(run):
    read_counters = getattr(run.cell.family, "counters", None)
    if run.profile is None or read_counters is None:
        return None
    counted = read_counters()
    held, most = counted.get("avt.moe.pairs_held"), counted.get("avt.moe.pairs_max")
    if not held or most is None:
        return None
    return most / (held / run.cell.cfg["n_routed_experts"])
