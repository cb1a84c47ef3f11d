"""Device operations (kernels, copies, fills) that start inside the
runner's spans of the traced stretch, per step call of those jobs."""


def read(run):
    t = run.trace
    if not t or not t["step_calls"]:
        return None
    return t["runner_device_ops"] / t["step_calls"]
