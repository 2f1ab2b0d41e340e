"""Mean host time of one call into the engine, ``ResilientEngine.infer(x,
sync=False)``, over the traced slice: the harness's own span around the
call on the host clock.  The harness realizes its oldest batch before it
dispatches another, so the call never waits at the engine's in-flight
cap: this is pad, staging, copy and launch on the host."""


def read(m):
    spans = m.trace.host_spans.get("engine.dispatch")
    if not spans:
        return None
    return 1e6 * sum(spans) / len(spans)
