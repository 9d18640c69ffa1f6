"""queue.host_ms_per_batch: the window's time per batch less the time
spent inside ``process`` (the engine's apply): what the host spends
around the engine, in the frame queue (the pinned upload, the readback's
wait and its copy out) and in the producer, a batch."""


def read(r):
    if not r.closed_loop or not r.window.batches:
        return None
    spans = r.window.spans["process"]
    return (r.window.seconds / r.window.batches - sum(spans) / len(spans)) * 1e3
