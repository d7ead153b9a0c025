"""Parallelism on `torch.distributed`, one process a rank (port of
`teal_tpu/parallel/`): rank meshes and their process groups (`mesh`),
start-up (`distributed`), tensor parallelism (`tp`: shardings and the
sharded forward; `tp_kernel`: decode through the kernels a shard a
rank), sequence-parallel prefill (`sp`) and pipeline parallelism
(`pp`)."""

from teal_tpu_torch.parallel.mesh import AxisGroup, Mesh, make_mesh
from teal_tpu_torch.parallel.tp import (param_specs, shard_cache,
                                        shard_params, sharded_forward)
from teal_tpu_torch.parallel.pp import (make_pp_mesh, pp_forward,
                                        pp_param_specs, pp_shard_cache,
                                        pp_shard_params)
from teal_tpu_torch.parallel.sp import make_sp_mesh, sp_prefill
from teal_tpu_torch.parallel.tp_kernel import (make_tp_mesh, tp_kernel_decode,
                                               tp_prefill)
from teal_tpu_torch.parallel.distributed import (global_mesh,
                                                 initialize_distributed,
                                                 is_primary, local_card)

__all__ = ["make_mesh", "shard_params", "shard_cache", "param_specs",
           "make_pp_mesh", "pp_forward", "pp_shard_cache", "pp_shard_params",
           "make_sp_mesh", "sp_prefill", "make_tp_mesh",
           "tp_kernel_decode", "tp_prefill", "sharded_forward",
           "pp_param_specs", "initialize_distributed", "global_mesh",
           "is_primary", "local_card", "Mesh", "AxisGroup"]
