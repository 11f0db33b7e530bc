"""Test config: force an 8-device virtual CPU mesh before JAX initializes.

Mirrors the reference strategy of running distributed tests multi-process on
localhost without real accelerators (SURVEY.md §4, test/legacy_test/
test_dist_base.py) — here a single process with 8 virtual XLA CPU devices.
"""
import os

# Engine.fit's MFU probe AOT-compiles the train step once more per fit;
# ~0.4s x every Engine test would blow the suite's 870s budget.  The
# probe itself is covered directly (test_observability
# test_train_step_compiled_stats) and end-to-end by
# tools/bench_observability.py.
os.environ.setdefault("PADDLE_TPU_MFU_COST_ANALYSIS", "0")

# the shared multichip dryrun setup (paddle_tpu/testing/dryrun.py) —
# sets JAX_PLATFORMS=cpu + the host-device-count flag before the CPU
# client initializes (importing paddle_tpu does not initialize it)
from paddle_tpu.testing.dryrun import force_cpu_devices

force_cpu_devices(8)

import jax  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight E2E (subprocess fault drills etc.) excluded "
        "from the tier-1 'not slow' run")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the PyTorch/CUDA port's kernels); "
        "skips itself when no CUDA device is present")
