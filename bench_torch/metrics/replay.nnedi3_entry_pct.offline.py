"""replay.nnedi3_entry_pct.offline: the share of the passes with an nnedi3
basename, over the frames of the run, that the program's nnedi3 entry
computed rather than declined to the generic evaluator, in percent
(``Engine.replay_stats()``'s ``nnedi3_passes`` over ``nnedi3_passes`` +
``nnedi3_declined``, counters the program keeps). Nothing where the
program keeps no such counters or ran no such pass."""


def read(r):
    done, declined = r.counters.get("nnedi3_passes"), r.counters.get("nnedi3_declined")
    if done is None or declined is None or not done + declined:
        return None
    return 100.0 * done / (done + declined)
