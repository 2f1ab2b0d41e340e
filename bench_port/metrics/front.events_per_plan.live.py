"""Events served per plan the live front dispatched: the window's events
over the engine's ``loop_plans`` counter, read before and after the
window.  A bucket of 256 holds at most 256."""


def read(m):
    plans = m.outcome.counters.get("loop_plans", 0)
    if not plans:
        return None
    return m.outcome.window_events / plans
