"""replay.fc_grouped_pct.offline: the share of the frames run through the
chain that took the fc-period grouped batch branch, in percent, over the
run (``Engine.replay_stats()``'s ``fc_grouped_frames`` over its
``frames``, counters the program keeps). Nothing where the program keeps
no such counters."""


def read(r):
    frames, grouped = r.counters.get("frames"), r.counters.get("fc_grouped_frames")
    if not frames or grouped is None:
        return None
    return 100.0 * grouped / frames
