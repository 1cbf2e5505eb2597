"""Telemetry of the port (counterpart of bigdl_tpu.telemetry): one
process-global, thread-safe span timeline fed by every metrics phase
timer and the engines' lifecycle instants, its exporters (Chrome trace
JSON for ``ui.perfetto.dev``, TensorBoard scalars through
``visualization``, newline-JSON metrics), a :class:`Watchdog` over the
span stream, cost and MFU accounting, the program X-ray (registry,
recompile forensics, HBM ledger), the request X-ray (exact per-request
latency attribution, tail exemplars), the workload recorder, the
numerics observatory (in-step gradient statistics, NaN provenance), the
flight recorder, the live debug server and the cluster shipper,
aggregator and federated watchdog.

Instrumentation is host-side only, but for the numerics stats, which the
train step computes when asked to: a captured CUDA graph launches the
same kernels and gives bit-equal outputs with tracing, the recorder and
the server on or off, and a disabled tracer costs one attribute check
per record site.
"""
from bigdl_tpu_torch.telemetry.cluster import (
    ClusterAggregator,
    FederatedWatchdog,
    TelemetryShipper,
)
from bigdl_tpu_torch.telemetry.costmodel import (
    CostTable,
    ProgramCost,
    get_cost_table,
    mfu,
    peak_flops_per_device,
)
from bigdl_tpu_torch.telemetry.debug_server import (
    DebugServer,
    attach_engine,
    bound_address,
    debug_port,
    get_debug_server,
    prometheus_text,
)
from bigdl_tpu_torch.telemetry.export import (
    chrome_trace,
    metrics_record,
    read_metrics_jsonl,
    write_chrome_trace,
    write_metrics_jsonl,
    write_scalars,
)
from bigdl_tpu_torch.telemetry.flightrecorder import (
    FlightRecorder,
    flight_enabled,
    get_flight_recorder,
)
from bigdl_tpu_torch.telemetry.numerics import (
    NUMERICS_EVENT,
    NUMERICS_SAMPLE,
    PROVENANCE_EVENT,
    RECOVERY_EVENT,
    NumericsMonitor,
    NumericsSpec,
    nan_provenance,
    subsample_tree,
)
from bigdl_tpu_torch.telemetry.programs import (
    HbmLedger,
    ProgramRecord,
    ProgramRegistry,
    ProgramSignature,
    diff_signatures,
    get_hbm_ledger,
    get_program_registry,
    signature_of,
    xray_enabled,
)
from bigdl_tpu_torch.telemetry.requests import (
    Attribution,
    ExemplarReservoir,
    RequestLedger,
    assemble_request_trees,
    request_trace_enabled,
)
from bigdl_tpu_torch.telemetry.tracer import (
    CAT_DATA,
    CAT_DECODE,
    CAT_HOST,
    CAT_SERVE,
    CAT_TRAIN,
    Span,
    Tracer,
    correlate,
    disable,
    enable,
    enabled,
    get_correlation,
    get_tracer,
    set_correlation,
)
from bigdl_tpu_torch.telemetry.watchdog import Watchdog
from bigdl_tpu_torch.telemetry.workload import (
    WorkloadRecorder,
    load_workload,
)

__all__ = [
    "Span", "Tracer", "Watchdog",
    "TelemetryShipper", "ClusterAggregator", "FederatedWatchdog",
    "DebugServer", "get_debug_server", "attach_engine",
    "bound_address", "debug_port", "prometheus_text",
    "FlightRecorder", "get_flight_recorder", "flight_enabled",
    "NumericsMonitor", "NumericsSpec", "nan_provenance",
    "subsample_tree", "NUMERICS_SAMPLE", "NUMERICS_EVENT",
    "PROVENANCE_EVENT", "RECOVERY_EVENT",
    "CostTable", "ProgramCost", "get_cost_table", "mfu",
    "peak_flops_per_device",
    "ProgramRegistry", "ProgramRecord", "ProgramSignature",
    "HbmLedger", "signature_of", "diff_signatures",
    "get_program_registry", "get_hbm_ledger", "xray_enabled",
    "get_tracer", "enable", "disable", "enabled",
    "correlate", "set_correlation", "get_correlation",
    "chrome_trace", "write_chrome_trace", "write_scalars",
    "metrics_record", "write_metrics_jsonl", "read_metrics_jsonl",
    "RequestLedger", "Attribution", "ExemplarReservoir",
    "assemble_request_trees", "request_trace_enabled",
    "WorkloadRecorder", "load_workload",
    "CAT_TRAIN", "CAT_DATA", "CAT_SERVE", "CAT_DECODE", "CAT_HOST",
]
