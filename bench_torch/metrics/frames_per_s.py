"""frames_per_s: 1080p u8 frames delivered to the host over the whole
window of a closed loop, divided by its length (host clock)."""


def read(r):
    if not r.closed_loop:
        return None
    return r.window.frames / r.window.seconds
