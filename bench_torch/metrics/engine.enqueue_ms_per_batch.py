"""engine.enqueue_ms_per_batch: the host's time inside ``Engine.apply(...,
output="u8")`` a batch (its mean over the window). ``apply`` returns
before the device has finished, so this is the host's own work: the
replayed walk's launch, the blit's quantize, the state's commit."""


def read(r):
    if not r.closed_loop:
        return None
    spans = r.window.spans["process"]
    return sum(spans) / len(spans) * 1e3 if spans else None
