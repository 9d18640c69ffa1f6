"""replay.capture_s: seconds the engine spent in first walks and CUDA graph
captures (``Engine.replay_stats()["capture_seconds"]``, a counter the
program keeps)."""


def read(r):
    return r.counters.get("capture_seconds")
