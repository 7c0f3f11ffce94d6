"""Device ms per engine step: the union of device activity in the
traced window over the engine steps issued in it."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["steps"] or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["steps"]
