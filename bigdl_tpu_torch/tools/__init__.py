"""Operator tools of the port, run as ``python -m
bigdl_tpu_torch.tools.<name>``: ``blackbox`` (a flight-recorder bundle as
a post-mortem) and ``cluster_top`` (a cluster telemetry run directory as
a table, or its hosts' live debug endpoints)."""
