"""Engine host ms per step: the engine's own dispatch, blocking host
fetch and telemetry seconds (`decode_step_breakdown`) over the window's
steps."""


def read(run):
    return 1e3 * run["host_s"] / run["steps"] if run["steps"] else None
