"""Worker for the two-process SAMPLER collectives test.

Launched twice by tests/test_multihost.py (process_id 0 and 1), each
with 2 virtual CPU devices: builds the 4-device global mesh across the
process boundary, runs ``sample_mh`` (walker-sharded) and ``sample_pt``
(rung-sharded — its replica exchange is a ``ppermute`` that must cross
the process boundary here) with the SAME seeds/kwargs as a single-process
reference the parent test computed, and asserts the results are
seed-identical: sharding distributes rows, it must not change them.

Usage: python _multihost_sampler_worker.py <pid> <port> <ref_npz>
"""

import os
import sys


def main():
    pid, port, ref_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from tpu21cmvae.parallel.mesh import make_mesh, multihost_init
    from tpu21cmvae.sampling import sample_mh, sample_pt

    multihost_init(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.device_count() == 4

    ref = np.load(ref_path)
    mu = ref["mu"]
    sig = ref["sig"]
    bounds = ref["bounds"]

    def loglik(params, x):
        z = (jnp.asarray(x) - mu) / sig
        return -0.5 * jnp.sum(z * z, axis=-1)

    mesh = make_mesh()

    res = sample_mh(
        loglik, None, n_walkers=16, n_steps=60, n_warmup=40, thin=5,
        bounds=bounds, seed=5, mesh=mesh,
    )
    np.testing.assert_allclose(res.chain, ref["mh_chain"], atol=1e-6)
    np.testing.assert_allclose(res.final, ref["mh_final"], atol=1e-6)
    np.testing.assert_allclose(res.logp, ref["mh_logp"], atol=1e-4)
    np.testing.assert_allclose(
        res.accept_rate, ref["mh_accept"], atol=1e-5
    )

    pt = sample_pt(
        loglik, None, n_rungs=4, n_walkers=8, n_steps=40, n_warmup=30,
        thin=5, bounds=bounds, seed=7, mesh=mesh,
    )
    np.testing.assert_allclose(pt.chain, ref["pt_chain"], atol=1e-6)
    np.testing.assert_allclose(pt.final, ref["pt_final"], atol=1e-6)
    np.testing.assert_allclose(
        pt.swap_rate, ref["pt_swap"], atol=1e-5
    )

    # round-5: batched nested sampling, live axis sharded over the
    # 4-device global mesh — per-row logz must match the single-process
    # reference (sharding distributes live points, not results)
    from tpu21cmvae.nested import nested_sampling_batch

    mus2 = ref["mus2"]

    def loglik_multi(params, x):
        xr = jnp.asarray(x).reshape(2, -1, 3)
        z = (xr - mus2[:, None, :]) / sig
        return (-0.5 * jnp.sum(z * z, axis=-1)).reshape(-1)

    nb = nested_sampling_batch(
        loglik_multi, None, 2, bounds=bounds, n_live=32, n_batch=4,
        n_mh=6, max_iters=256, iters_per_chunk=16, seed=9, mesh=mesh,
    )
    np.testing.assert_allclose(
        np.array([r.logz for r in nb]), ref["nb_logz"], atol=1e-3
    )
    assert [r.n_iters for r in nb] == list(ref["nb_iters"])

    print(f"SAMPLER-OK {pid}", flush=True)


if __name__ == "__main__":
    main()
