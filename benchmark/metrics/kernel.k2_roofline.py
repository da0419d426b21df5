"""kernel.k2_roofline (%): K2, the IMU error-state affine chain
(dliom_tpu_torch/csrc/affine_chain.cu), as a share of its roofline: the
least time of the chain's bytes and float32 operations
(roofline.k2_work over the lanes and the valid IMU samples a scan), over
K2's time a call in the device trace."""

from benchmark.metrics import roofline

SOURCE = "device_trace"
KERNELS = ("affine_chain_kernel",)


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    calls, seconds = 0, 0.0
    for n, (c, s) in t["by_name"].items():
        if any(k in n for k in KERNELS):
            calls, seconds = calls + c, seconds + s
    if not calls or seconds <= 0:
        return None
    nbytes, flops = roofline.k2_work(ctx["lanes"], ctx["imu_samples"])
    return 100.0 * calls * roofline.bound(nbytes, flops)[0] / seconds
