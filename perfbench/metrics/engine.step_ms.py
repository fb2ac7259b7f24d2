"""engine.step_ms: mean wall time of LLMEngine.step over the window's steps,
timed by the benchmark's wrapper of the engine's step (host clock)."""


def read(rec):
    xs = rec.host.get("step_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
