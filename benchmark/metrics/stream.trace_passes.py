"""stream.trace_passes: the whole-file passes the sampled window fit made
for tr(A'A) before its loop (``res.misc["stream"]["trace_passes"]``, 0 or
1); none where the program does not count them."""


def read(run):
    stream = (getattr(run.sample, "misc", None) or {}).get("stream")
    return stream.get("trace_passes") if stream else None
