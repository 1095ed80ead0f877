"""Multi-device layer: device meshes, parameter/cache shardings, and the
collectives that take the place of the reference's DSM cluster reductions
across GPUs (SURVEY.md §2.4)."""

from clusterfusion.parallel.mesh import build_mesh
from clusterfusion.parallel.sharding import (
    param_pspecs,
    param_shardings,
    cache_pspec,
    cache_shardings,
    shard_params,
)
from clusterfusion.parallel.decode import make_sharded_decode_step, make_sharded_serving_step
from clusterfusion.parallel.sp_decode import (
    cache_pspec_2d,
    cache_shardings_2d,
    make_sp_sharded_decode_step,
)
from clusterfusion.parallel.collective import (
    Stage,
    cluster_gather,
    cluster_reduce,
)
from clusterfusion.parallel.pp import (
    make_pp_train_step,
    pipeline_lm_loss,
    pp_param_shardings,
    shard_params_pp,
)
from clusterfusion.parallel.ep import make_ep_moe_ffn
