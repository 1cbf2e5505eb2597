"""The distributed engine of the port (counterpart of bigdl_tpu.parallel):
the mesh over ``torch.distributed`` ranks, the data-parallel train and
eval steps with ZeRO-1, and tensor, sequence, pipeline and expert
parallelism.  Names load on first use, so the layers can import
``parallel.comm`` and ``parallel.mesh`` without the steps.
"""
import importlib

_WHERE = {
    "mesh": ("DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh",
             "MeshConfig", "PlanInfo", "Replicated", "RowShard", "Sharded",
             "batch_sharding", "data_parallel_mesh", "elastic_mesh",
             "init_process_group", "make_mesh", "plan_info", "put_batch",
             "replicated", "shard_leading_dim"),
    "data_parallel": ("build_dp_train_step", "build_dp_eval_step"),
    "tensor_parallel": ("TRANSFORMER_RULES", "CONVNET_RULES",
                        "make_param_shardings", "describe_shardings",
                        "shard_variables", "gather_variables"),
    "pipeline": ("PIPE_AXIS", "init_stacked_params",
                 "stacked_param_sharding", "pipeline_apply",
                 "build_pipeline_train_step", "PipelinedLM",
                 "pipelined_transformer_lm"),
    "expert": ("MoE", "expert_param_shardings",
               "transformer_expert_shardings"),
    "sequence": ("ring_attention", "ulysses_attention",
                 "RingSelfAttention"),
}
_MODULE_OF = {name: mod for mod, names in _WHERE.items() for name in names}


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_MODULE_OF))


__all__ = sorted(_MODULE_OF)
