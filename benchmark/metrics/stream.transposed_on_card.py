"""stream.transposed_on_card: the transposed panels the sampled window fit
built on the device from its cached forward panels instead of reading the
file's transpose stream (``res.misc["stream"]["transposed_on_card"]``);
none where the program does not count them."""


def read(run):
    stream = (getattr(run.sample, "misc", None) or {}).get("stream")
    return stream.get("transposed_on_card") if stream else None
