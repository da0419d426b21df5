"""The compiled step's stage marks (dliom_tpu_torch/common/stages.py), as
the program's `counts()` carries them in the loop's ctx["counts"]["marks"]:
medians over the replays the graph's ring holds (the run's, set-up's and
the traced stretch's included, up to 512), each stage's device time
between the marks captured at its ends and its kernels counted at the
capture. A program without marks gives no `marks`, and every reader then
reads nothing (None)."""


def summary(ctx):
    """The marks' summary of the run's compiled step, or None."""
    return (ctx.get("counts") or {}).get("marks") or None


def value(ctx, key: str):
    """A number of the summary (`device_ms`)."""
    m = summary(ctx)
    return None if m is None else m.get(key)


def stage(ctx, name: str, field: str):
    """`field` ("ms" or "kernels") of the stage whose span name ends in
    `name` (`match` is `frontend.match`; `rest`, the step outside its
    stages, is `rest`)."""
    m = summary(ctx)
    for full, v in ((m or {}).get("stages") or {}).items():
        if full.rpartition(".")[2] == name:
            return v.get(field)
    return None
