"""Two-process ``jax.distributed`` smoke test for ``multihost_init``.

The framework's multi-host story (SURVEY.md §2.3/§5: processes joined
by ``jax.distributed.initialize``, XLA collectives within a host) cannot
be exercised on single-host CI by the in-process 8-device mesh — that
mesh is one process. This test spawns two REAL processes with 2 virtual
CPU devices each, initializes the distributed runtime, and reduces a
globally sharded array across them (tests/_multihost_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
SAMPLER_WORKER = os.path.join(
    os.path.dirname(__file__), "_multihost_sampler_worker.py"
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_init():
    port = _free_port()
    env = {
        **os.environ,
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    # the workers pin their own JAX_PLATFORMS/XLA_FLAGS; drop this
    # process's virtual-device settings so they don't leak through
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{err[-2000:]}"
    assert any("OK 0" in out for _, out, _ in outs)
    assert any("OK 1" in out for _, out, _ in outs)


@pytest.mark.distributed
@pytest.mark.slow
def test_two_process_sampler_collectives(tmp_path):
    """Round-3 VERDICT #7: sampler collectives across a REAL process
    boundary. The parent computes single-process references for
    ``sample_mh`` (walker-sharded) and ``sample_pt`` (rung-sharded —
    its replica exchange rides a ``ppermute`` that here crosses the
    two-process boundary); the two workers rerun both over the
    4-device global mesh with identical seeds and assert seed-identical
    chains. Sharding distributes rows; it must not change them."""
    import numpy as np

    import jax.numpy as jnp

    from tpu21cmvae.sampling import sample_mh, sample_pt

    mu = np.array([0.3, -0.6, 1.2], np.float32)
    sig = np.array([0.5, 0.25, 0.8], np.float32)
    bounds = np.stack([mu - 10 * sig, mu + 10 * sig], axis=1)

    def loglik(params, x):
        z = (jnp.asarray(x) - mu) / sig
        return -0.5 * jnp.sum(z * z, axis=-1)

    res = sample_mh(loglik, None, n_walkers=16, n_steps=60,
                    n_warmup=40, thin=5, bounds=bounds, seed=5)
    pt = sample_pt(loglik, None, n_rungs=4, n_walkers=8, n_steps=40,
                   n_warmup=30, thin=5, bounds=bounds, seed=7)

    # round-5: the batched definitive evidence tier over the same mesh
    # (two observations, live axis sharded)
    from tpu21cmvae.nested import nested_sampling_batch

    mus2 = np.stack([mu, mu + 0.5 * sig]).astype(np.float32)

    def loglik_multi(params, x):
        xr = jnp.asarray(x).reshape(2, -1, 3)
        z = (xr - mus2[:, None, :]) / sig
        return (-0.5 * jnp.sum(z * z, axis=-1)).reshape(-1)

    nb = nested_sampling_batch(
        loglik_multi, None, 2, bounds=bounds, n_live=32, n_batch=4,
        n_mh=6, max_iters=256, iters_per_chunk=16, seed=9,
    )
    ref_path = tmp_path / "ref.npz"
    np.savez(
        ref_path, mu=mu, sig=sig, bounds=bounds, mus2=mus2,
        mh_chain=res.chain, mh_final=res.final, mh_logp=res.logp,
        mh_accept=res.accept_rate,
        pt_chain=pt.chain, pt_final=pt.final, pt_swap=pt.swap_rate,
        nb_logz=np.array([r.logz for r in nb]),
        nb_iters=np.array([r.n_iters for r in nb]),
    )

    port = _free_port()
    env = {
        **os.environ,
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, SAMPLER_WORKER, str(pid), str(port),
             str(ref_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost sampler workers timed out")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{err[-3000:]}"
    assert any("SAMPLER-OK 0" in out for _, out, _ in outs)
    assert any("SAMPLER-OK 1" in out for _, out, _ in outs)
