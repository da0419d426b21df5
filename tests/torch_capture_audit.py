"""The capture audit shared by the compiled programs' CPU tests
(tests/test_torch_compiled_step.py, tests/test_torch_compiled_backend.py):
a program run under `Uncapturable` on the CPU counts the ops that a CUDA
graph capture would refuse on the card (a host read, a tensor built from
host data, an op whose output size depends on the data), outside the
kernels' plain versions (the card runs the kernels there)."""

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dliom_tpu_torch.imu import affine_chain as ac
from dliom_tpu_torch.ops import grouped_apply as ga

# ops a CUDA graph capture refuses: host reads, host data, data-dependent sizes
UNCAPTURABLE = {"aten._local_scalar_dense.default", "aten.lift_fresh.default", "aten.nonzero.default",
                "aten.repeat_interleave.Tensor", "aten.masked_select.default", "aten._unique2.default",
                "aten.unique_dim.default", "aten.unique_consecutive.default"}
PLAIN_KERNELS = ((ga, "apply_grouped_rows_plain"), (ga, "apply_grouped_updates_plain"),
                 (ac, "affine_chain_plain"))


class Uncapturable(TorchDispatchMode):
    """Counts the uncapturable ops issued outside the kernels' plain versions."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()
        self.ops = 0
        self.inside_plain = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = str(func)
        bad = name in UNCAPTURABLE or (
            name.startswith(("aten.index.Tensor", "aten.index_put"))
            and any(i is not None and i.dtype == torch.bool for i in args[1]))
        if bad and not self.inside_plain:
            self.found[name] += 1
        return func(*args, **(kwargs or {}))


def audited(monkeypatch, fn):
    """fn() under `Uncapturable`, the kernels' plain versions excluded."""
    mode = Uncapturable()
    for mod, name in PLAIN_KERNELS:
        plain = getattr(mod, name)

        def excluded(*a, _plain=plain, **k):
            mode.inside_plain += 1
            try:
                return _plain(*a, **k)
            finally:
                mode.inside_plain -= 1

        monkeypatch.setattr(mod, name, excluded)
    with mode:
        fn()
    return mode
