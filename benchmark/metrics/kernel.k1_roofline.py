"""kernel.k1_roofline (%): K1, the grouped grid-update apply
(dliom_tpu_torch/csrc/grouped_apply.cu), as a share of its roofline: the
least time the bytes its inputs need take at the card's memory rate
(roofline.k1_bytes, counted from the records and cells the reference's
plain apply is given on the mix's `roofline_steps`, the same window steps
on every seed, every lane), over K1's device time on the same steps,
replayed once more from their own pre-step states under the profiler
after the window. A kernel that replaces K1 is held to the same work:
list its names in KERNELS."""

from benchmark.metrics import roofline

SOURCE = "device_trace"
KERNELS = ("grouped_apply_kernel", "dense_apply_kernel")


def read(ctx):
    t = ctx.get("roofline_trace")
    nbytes = ctx.get("k1_bytes")
    if not t or not nbytes:
        return None
    seconds = sum(v[1] for n, v in t["by_name"].items() if any(k in n for k in KERNELS))
    if seconds <= 0:
        return None
    return 100.0 * roofline.bound(nbytes)[0] / seconds
