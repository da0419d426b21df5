"""The port's config copy and import hygiene (dliom_tpu_torch).

The config is a copy (importing dliom_tpu.common.config imports jax), so
the two dataclass trees must stay equal: same fields, defaults and presets.
The port must import with jax blocked, so the CUDA host needs no JAX.
"""

import dataclasses
import pkgutil
import subprocess
import sys

import pytest
import torch

import dliom_tpu_torch
from dliom_tpu.common import config as jcfg
from dliom_tpu_torch.common import config as tcfg
import torch_threads  # noqa: F401  (one torch thread per test process)


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                [(f.name, _tree(getattr(obj, f.name))) for f in dataclasses.fields(obj)])
    return obj


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_presets_equal(preset):
    assert dataclasses.asdict(tcfg.load_config(preset)) == dataclasses.asdict(jcfg.load_config(preset))
    assert _tree(tcfg.load_config(preset)) == _tree(jcfg.load_config(preset))


def test_overrides_and_unknown_keys():
    over = {"trajectory_builder": {"submaps": {"use_brick_grid": True, "brick_apply_groups": 64}}}
    assert dataclasses.asdict(tcfg.load_config("viral", over)) == \
        dataclasses.asdict(jcfg.load_config("viral", over))
    with pytest.raises(KeyError):
        tcfg.load_config("basic", {"trajectory_builder": {"no_such_key": 1}})
    with pytest.raises(KeyError):
        tcfg.load_config("no_such_preset")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(dliom_tpu_torch.__path__, "dliom_tpu_torch."))


def test_imports_without_jax():
    """Every port module imports with `import jax` made to fail."""
    mods = ["dliom_tpu_torch"] + _all_modules()
    code = "import sys\nsys.modules['jax'] = None\n" + "\n".join(
        f"import {m}" for m in mods) + "\nassert 'jax.numpy' not in sys.modules\nprint('ok')"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_f32_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_device_helper():
    from dliom_tpu_torch.common.device import get_device

    assert get_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            get_device("cuda")
