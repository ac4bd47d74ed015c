"""host_syncs: the sampled window fit's synchronizing calls as the program
counts them where it makes them (``res.misc["host_syncs"]``: each host read
of a device value, each blocking copy of a host array to the card)."""


def read(run):
    misc = getattr(run.sample, "misc", None) or {}
    value = misc.get("host_syncs")
    return float(value) if value is not None else None
