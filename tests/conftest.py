"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without accelerator hardware."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
# no persistent compile cache for tests: XLA:CPU entries embed host CPU
# features and do not reload reliably, and concurrent writers have crashed
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
