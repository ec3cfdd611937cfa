"""viewer.host_ms_per_tick: the mean over the traced run's ticks of the
tick's wall time less its "tick.pass" span (_pt_step_chunk with its
result awaited): the viewer's host work a tick, in ms."""


def read(run):
    ticks = run.spans.durations("tick")
    passes = run.spans.durations("tick.pass")
    if not ticks or len(ticks) != len(passes):
        return None
    return 1e3 * sum(t - p for t, p in zip(ticks, passes)) / len(ticks)
