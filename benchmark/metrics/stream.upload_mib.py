"""stream.upload_mib: the bytes the sampled window fit copied to the device
as panels (``res.misc["stream"]["upload_bytes"]``), in MiB."""


def read(run):
    stream = (getattr(run.sample, "misc", None) or {}).get("stream")
    return stream["upload_bytes"] / 2**20 if stream else None
