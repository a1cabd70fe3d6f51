"""Export a trained emulator as a self-contained deployment artifact.

The reference deploys by shipping Keras ``.h5`` weights that need the
package, TensorFlow, and the training data's normalization statistics at
load time (reference ``emulator.py:319-337``; ``preprocess.py:88-101``).
Here the whole fused chain — ``par_transform → MLP → unpreproc`` with
weights and normalization folded in — serializes as ONE StableHLO binary
(:mod:`tpu21cmvae.deploy`, ``jax.export``) with a symbolic batch
dimension and cpu+cuda lowering. The consumer side needs JAX and nothing
else, as the replay section below demonstrates by bypassing the package
entirely.

Usage:
    python examples/deploy_artifact.py                 # shipped checkpoint
    python examples/deploy_artifact.py --model m.npz --obs obs.npz
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--model",
        default=os.path.join(ROOT, "pretrained", "direct_synthetic.npz"),
        help="checkpoint to export (default: the shipped direct model)",
    )
    ap.add_argument("--out-dir", default=None,
                    help="where to write the artifacts (default: tmp)")
    ap.add_argument("--obs", default=None, metavar="FILE",
                    help="observation spec file (same formats as "
                         "serve --warmup-obs); default: a synthetic "
                         "noisy observation of the model itself")
    args = ap.parse_args()

    from tpu21cmvae import (
        load_artifact,
        save_loglik_artifact,
        save_predict_artifact,
        save_valgrad_artifact,
    )
    from tpu21cmvae.models import load_model

    model = load_model(args.model)
    out = args.out_dir or tempfile.mkdtemp(prefix="tpu21cmvae_deploy_")
    os.makedirs(out, exist_ok=True)

    rng = np.random.default_rng(0)
    if args.obs is not None:
        from tpu21cmvae.serve import load_obs_specs

        specs = load_obs_specs(args.obs)
        obs_noisy, noise_var = specs[0]
        # keep per-bin noise arrays as-is (the artifact savers accept
        # them directly); only scalars get the float conversion
        if np.ndim(noise_var) == 0:
            noise_var = float(noise_var)
    else:
        theta = np.asarray(
            [[0.1, 30.0, 1.0, 0.06, 1.2, 19.0, 30.0]], np.float32
        )
        obs = np.asarray(model.predict(theta[0]))
        obs_noisy = obs + rng.normal(0.0, 5.0, obs.shape)
        noise_var = 25.0

    # --- producer side: three artifacts, one call each -----------------
    p_pred = save_predict_artifact(model, os.path.join(out, "predict.bin"))
    p_ll = save_loglik_artifact(
        model, os.path.join(out, "loglik.bin"), obs_noisy, noise_var
    )
    p_vg = save_valgrad_artifact(
        model, os.path.join(out, "valgrad.bin"), obs_noisy, noise_var
    )
    for p in (p_pred, p_ll, p_vg):
        print(f"wrote {p} ({os.path.getsize(p):,} bytes)")

    # --- consumer side, package-assisted --------------------------------
    fn = load_artifact(p_pred)
    batch = rng.uniform(0.2, 0.8, (1024, 7)).astype(np.float32)
    sig = fn(batch)  # any batch size: the export is batch-polymorphic
    print(f"predict artifact: {batch.shape} → {sig.shape}, "
          f"platforms {fn.platforms}")

    v, g = load_artifact(p_vg)(batch[:64])
    print(f"valgrad artifact: logL {v.shape}, grad {g.shape} — feed "
          "this to an external HMC/NUTS implementation")

    # --- consumer side, RAW JAX (what a non-tpu21cmvae user runs) ------
    from jax import export as jxe

    replay = jxe.deserialize(bytearray(open(p_ll, "rb").read()))
    ll = np.asarray(replay.call(batch[:8]))
    print(f"raw jax.export replay of the likelihood: {ll.shape}, "
          f"max logL {ll.max():.1f}")


if __name__ == "__main__":
    main()
