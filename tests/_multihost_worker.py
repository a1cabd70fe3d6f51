"""Worker for the two-process ``jax.distributed`` smoke test.

Launched twice by tests/test_multihost.py (process_id 0 and 1), each
with 2 virtual CPU devices: initializes the distributed runtime through
``tpu21cmvae.parallel.mesh.multihost_init``, builds the global mesh, and
runs one all-process reduction over a process-local-sharded array — the
minimal proof that the multi-process path (SURVEY.md §5 "distributed backend") is
wired, not just aliased.
"""

import os
import sys


def main():
    pid, port = int(sys.argv[1]), sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    # as in tests/conftest.py: set the config too, before any backend
    # initializes, so the worker never opens an accelerator
    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu21cmvae.parallel.mesh import make_mesh, multihost_init

    multihost_init(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    assert jax.local_device_count() == 2, jax.local_device_count()

    mesh = make_mesh()  # global: both processes' devices
    local = np.full((4, 3), float(pid + 1), np.float32)
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), local, (8, 3)
    )
    total = jax.jit(
        lambda a: jnp.sum(a), out_shardings=NamedSharding(mesh, P())
    )(arr)
    np.testing.assert_allclose(np.asarray(total), 12.0 * 1 + 12.0 * 2)
    print(f"OK {pid}", flush=True)


if __name__ == "__main__":
    main()
