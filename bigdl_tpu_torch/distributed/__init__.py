"""Elastic fault tolerance for DistriOptimizer (counterpart of
bigdl_tpu.distributed): sharded checkpoints with a two-phase commit and
resharding restore (in the JAX package's files), compressed gradient
exchange, the file rendezvous, the elastic agent and its worker.

The worker (``python -m bigdl_tpu_torch.distributed.worker``) is not
imported here: the agent spawns it as a process of its own.
"""
from bigdl_tpu_torch.distributed.checkpoint import (ShardedCheckpointer,
                                                    ShardedLeaf,
                                                    build_reshard_step,
                                                    latest_committed,
                                                    restore_checkpoint,
                                                    write_checkpoint)
from bigdl_tpu_torch.distributed.compression import (
    WIRE_DTYPES, build_compressed_dp_train_step, fp16_compress)
from bigdl_tpu_torch.distributed.elastic import (ElasticAgent,
                                                 ElasticDistriOptimizer)
from bigdl_tpu_torch.distributed.rendezvous import FileRendezvous, free_port

__all__ = ["ElasticAgent", "ElasticDistriOptimizer", "FileRendezvous",
           "ShardedCheckpointer", "ShardedLeaf", "WIRE_DTYPES",
           "build_compressed_dp_train_step", "build_reshard_step",
           "fp16_compress", "free_port", "latest_committed",
           "restore_checkpoint", "write_checkpoint"]
