"""train_tok_s: B x S tokens of the steps taken in the window, over the
window closed by a synchronize (host clock)."""


def read(rec):
    h = rec.host
    return h["tokens"] / h["window_s"] if h.get("steps") else None
