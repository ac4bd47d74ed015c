"""stream.wait_ms: the time the sampled window fit's own thread waited on
panel reads (``res.misc["stream"]["wait_s"]``, the program's
``rtt.stream.wait`` spans): the decode the fit did not hide, in ms."""


def read(run):
    stream = (getattr(run.sample, "misc", None) or {}).get("stream")
    return stream["wait_s"] * 1e3 if stream else None
