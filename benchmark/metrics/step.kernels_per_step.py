"""step.kernels_per_step (kernels/step): device kernels a compiled step
launches (its CUDA graph replay), counted in the device trace of the
traced stretch (copies and sets left out) over the steps traced."""

SOURCE = "device_trace"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"] or not t["kernels"]:
        return None
    return t["kernels"] / t["steps"]
