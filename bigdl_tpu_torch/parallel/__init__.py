"""The distributed engine of the port (counterpart of bigdl_tpu.parallel):
the mesh over ``torch.distributed`` ranks and the data-parallel train
and eval steps with ZeRO-1.  Tensor, sequence, pipeline and expert
parallelism are port slice 20: their names raise ``NotImplementedError``.
"""
from bigdl_tpu_torch.parallel.data_parallel import (build_dp_eval_step,
                                                    build_dp_train_step)
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                           MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                                           Mesh, MeshConfig, PlanInfo,
                                           Replicated, RowShard,
                                           batch_sharding,
                                           data_parallel_mesh, elastic_mesh,
                                           init_process_group, make_mesh,
                                           plan_info, put_batch, replicated,
                                           shard_leading_dim)

#: names of bigdl_tpu.parallel that port slice 20 brings
SLICE_20 = ("TRANSFORMER_RULES", "make_param_shardings",
            "describe_shardings", "ring_attention", "ulysses_attention",
            "RingSelfAttention", "init_stacked_params",
            "stacked_param_sharding", "pipeline_apply",
            "build_pipeline_train_step", "MoE", "expert_param_shardings")


def __getattr__(name):
    if name in SLICE_20:
        raise NotImplementedError(
            f"bigdl_tpu_torch.parallel.{name}: tensor, sequence, pipeline "
            "and expert parallelism are port slice 20")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
           "SEQ_AXIS", "Mesh", "MeshConfig", "PlanInfo", "Replicated",
           "RowShard", "batch_sharding", "build_dp_eval_step",
           "build_dp_train_step", "data_parallel_mesh", "elastic_mesh",
           "init_process_group", "make_mesh", "plan_info", "put_batch",
           "replicated", "shard_leading_dim"]
