"""stream.decode_ms: the host time the streaming engine's panel reads took
in the sampled window fit (decode and preparation, summed over the
Prefetcher's workers: ``res.misc["stream"]["decode_s"]``), in ms."""


def read(run):
    stream = (getattr(run.sample, "misc", None) or {}).get("stream")
    return stream["decode_s"] * 1e3 if stream else None
