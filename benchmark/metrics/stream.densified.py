"""stream.densified: the panels the sampled window fit densified on the
device from compact COO panels (``res.misc["stream"]["densified"]``); none
where the program does not count them."""


def read(run):
    stream = (getattr(run.sample, "misc", None) or {}).get("stream")
    return stream.get("densified") if stream else None
