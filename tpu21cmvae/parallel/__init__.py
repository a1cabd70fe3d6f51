from tpu21cmvae.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    make_mesh,
    replicate,
    shard_batch,
)
from tpu21cmvae.parallel.inference import ShardedEmulator  # noqa: F401
from tpu21cmvae.parallel.train_dp import (  # noqa: F401
    dp_fit,
    dp_fit_scan,
    make_dp_train_step,
)
