"""engine.occupancy: mean over the window's steps of the slots occupied in
the step (held after it, plus those retired in it) over max_slots, in %
(the engine's slot table)."""


def read(rec):
    xs = rec.host.get("occupancy")
    return 100.0 * sum(xs) / len(xs) if xs else None
