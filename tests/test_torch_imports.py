"""bigdl_tpu_torch must run where there is no JAX: it imports neither
``jax`` nor the JAX package, not even its numpy-only modules.  Nor does
it need ``fsspec`` (imported only for a remote path) or ``PIL`` to be
imported."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import bigdl_tpu_torch

PKG = Path(bigdl_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "bigdl_tpu", "fsspec", "PIL")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="bigdl_tpu_torch."))


def test_every_submodule_imports_without_jax_or_bigdl_tpu():
    mods = _modules()
    for m in ("ops.fused_matmul", "serving.engine", "optim.optimizer",
              "optim.optim_method", "dataset.dataset", "nn.criterion",
              "ops.flash_attention", "ops.attention", "nn.attention",
              "nn.dropout", "nn.embedding", "optim.validation",
              "dataset.text", "models.train_utils",
              "models.transformer_train", "nn.quantized", "ops.int8_matmul",
              "utils.serialization", "optim.prediction_service",
              "ops.paged_kv", "nn.beam_search", "serving.paging",
              "serving.decode", "dataset.prefetch", "optim.schedules",
              "optim.metrics", "models.resnet_train", "models.resnet",
              "dataset.record_io", "dataset.sharded", "dataset.seqfile",
              "dataset.cifar", "utils.file_io", "utils.protowire",
              "visualization", "visualization.tensorboard",
              "visualization.summary", "nn.fused_block", "nn.norm",
              "telemetry", "telemetry.tracer", "telemetry.export",
              "telemetry.watchdog", "telemetry.costmodel",
              "telemetry.programs", "telemetry.requests",
              "telemetry.workload", "telemetry.kernels",
              "telemetry.numerics", "telemetry.flightrecorder",
              "telemetry.debug_server", "telemetry.cluster",
              "utils.profiling", "tools", "tools.blackbox",
              "tools.cluster_top", "parallel", "parallel.mesh",
              "parallel.comm", "parallel.data_parallel", "ops.partition",
              "distributed", "distributed.checkpoint",
              "distributed.compression", "distributed.rendezvous",
              "distributed.elastic", "distributed.worker",
              "optim.distri_optimizer", "optim.sparse_update",
              "parallel.tensor_parallel", "parallel.sequence",
              "parallel.expert", "parallel.pipeline", "utils.table",
              "dataset.mnist", "models.lenet", "models.autoencoder",
              "models.lenet_train"):
        assert f"bigdl_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_line_imports_jax_or_bigdl_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|bigdl_tpu|PIL)"
        r"(\.|\s|$)")
    hits = [f"{p.relative_to(PKG)}:{i}: {line.strip()}"
            for p in PKG.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert hits == []


def test_fsspec_is_imported_only_inside_file_io_functions():
    """fsspec is optional (the card's machine has none): only
    utils/file_io.py imports it, inside the functions that take a remote
    path."""
    hits = [(p.relative_to(PKG).as_posix(), line)
            for p in PKG.rglob("*.py")
            for line in p.read_text().splitlines()
            if re.match(r"^\s*(import|from)\s+fsspec(\.|\s|$)", line)]
    assert hits and {f for f, _ in hits} == {"utils/file_io.py"}
    assert all(line.startswith(" ") for _, line in hits)


def test_the_spawned_worker_runs_without_jax_or_bigdl_tpu(tmp_path):
    """The elastic agent's worker process (``python -m
    bigdl_tpu_torch.distributed.worker``), run to its end at world 1 on
    the CPU, has imported none of them."""
    import os

    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_module('bigdl_tpu_torch.distributed.worker',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent),
               BIGDL_ELASTIC_WORKDIR=str(tmp_path), BIGDL_ELASTIC_ITERS="2",
               BIGDL_ELASTIC_DEVICE="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert (tmp_path / "worker-result-g1-r0.json").exists()
