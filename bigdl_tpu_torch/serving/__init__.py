"""Serving of the port (counterpart of bigdl_tpu.serving)."""
from bigdl_tpu_torch.serving.bucketing import Bucket, BucketGrid
from bigdl_tpu_torch.serving.decode import (
    DecodeEngine, build_decode_tick, build_draft_propose, build_page_reset,
    build_paged_tick, build_paged_write_slot, build_prefill,
    build_prefill_chunk, build_sampling_tick, build_spec_verify,
    build_write_slot, decode_program_check, decode_tick_fn,
    draft_propose_fn, page_reset_fn, paged_tick_fn, paged_write_slot_fn,
    prefill_chunk_fn, prefill_fn, sample_logits, sampling_tick_fn,
    spec_verify_fn, write_slot_fn)
from bigdl_tpu_torch.serving.engine import (DeadlineExceededError,
                                            EngineClosedError,
                                            QueueFullError, ServingEngine,
                                            ServingError, ServingFuture)
from bigdl_tpu_torch.serving.metrics import (PeriodicMetricsLogger,
                                             ServingMetrics)
from bigdl_tpu_torch.serving.paging import (OutOfPagesError, PageAllocator,
                                            default_num_pages,
                                            draft_k_default)
from bigdl_tpu_torch.serving.warmup import build_forward, compile_bucket

__all__ = ["Bucket", "BucketGrid", "DeadlineExceededError", "DecodeEngine",
           "EngineClosedError", "OutOfPagesError", "PageAllocator",
           "QueueFullError", "ServingEngine", "ServingError",
           "ServingFuture", "ServingMetrics", "PeriodicMetricsLogger",
           "build_decode_tick", "build_draft_propose",
           "build_forward", "build_page_reset", "build_paged_tick",
           "build_paged_write_slot", "build_prefill", "build_prefill_chunk",
           "build_sampling_tick", "build_spec_verify", "build_write_slot",
           "compile_bucket", "decode_program_check", "decode_tick_fn",
           "default_num_pages", "draft_k_default", "draft_propose_fn",
           "page_reset_fn", "paged_tick_fn", "paged_write_slot_fn",
           "prefill_chunk_fn", "prefill_fn", "sample_logits",
           "sampling_tick_fn", "spec_verify_fn", "write_slot_fn"]
