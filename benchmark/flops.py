"""Work of the model, from the configuration's published widths alone.

Never from the implementation: a gram fold, an analytic backward or a
fused kernel changes how the work is done, not how much the model
needs, so a share built on these numbers reads the same yardstick
whatever a later change does.

* model FLOP per row: ``F = 2 · Σ in·out`` over the layers of the
  emulation path (direct: 740,608; autoencoder emulator + decoder:
  1,002,880); a likelihood costs F, a value with its gradient 2F.
* computed bytes per row: one float32 HBM round trip of every layer's
  activations (its input read, its output written); a value with its
  gradient adds the backward's round trip (the upstream gradient and
  the saved activation read, the downstream gradient written).
"""

from __future__ import annotations

F32 = 4


def layer_shapes(config: dict) -> list:
    """``[(in, out), …]`` of every dense layer on the emulation path."""
    fam = config["family"]
    if fam == "direct":
        sizes = [config["n_params"], *config["hidden_dims"], config["n_bins"]]
        return list(zip(sizes[:-1], sizes[1:]))
    if fam == "ae":
        em = [config["n_params"], *config["em_hidden_dims"],
              config["latent_dim"]]
        dec = [config["latent_dim"], *config["dec_hidden_dims"],
               config["n_bins"]]
        return list(zip(em[:-1], em[1:])) + list(zip(dec[:-1], dec[1:]))
    raise ValueError(f"unknown model family {fam!r}")


#: passes over the model that one row of each entry needs
PASSES = {"predict": 1, "loglik": 1, "valgrad": 2}


def layer_work(config: dict, entry: str) -> list:
    """``[(flop, bytes), …]`` per row, one pair per layer."""
    passes = PASSES[entry]
    out = []
    for d_in, d_out in layer_shapes(config):
        flop = 2 * d_in * d_out * passes
        nbytes = (d_in + d_out) * F32
        if passes == 2:
            nbytes += (2 * d_out + d_in) * F32
        out.append((flop, nbytes))
    return out


def model_flop_per_row(config: dict, entry: str) -> int:
    return sum(f for f, _ in layer_work(config, entry))


def computed_bytes_per_row(config: dict, entry: str) -> int:
    return sum(b for _, b in layer_work(config, entry))


def least_time_s(config: dict, entry: str, rows: int, peak: dict):
    """``(seconds, bound)``: the least time the model's matmuls need for
    ``rows`` rows — per layer the larger of FLOP ÷ bf16 dense peak and
    computed bytes ÷ HBM bandwidth, summed; ``bound`` names the term
    that sets most of the total (``"flop"`` or ``"hbm"``)."""
    t_flop = t_hbm = total = 0.0
    for flop, nbytes in layer_work(config, entry):
        a = rows * flop / peak["bf16_dense_flop_per_s"]
        b = rows * nbytes / peak["hbm_bytes_per_s"]
        total += max(a, b)
        if a >= b:
            t_flop += a
        else:
            t_hbm += b
    return total, ("flop" if t_flop >= t_hbm else "hbm")
