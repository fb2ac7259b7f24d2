"""output_tok_s: output tokens handed over to callers inside the window,
over the window's seconds (host clock)."""


def read(rec):
    h = rec.host
    if "output_tokens" not in h:
        return None
    return h["output_tokens"] / h["window_s"]
