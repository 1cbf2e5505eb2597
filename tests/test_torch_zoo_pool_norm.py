"""The port's pooling and normalisation layers (nn/pool.py, nn/norm.py) against the JAX package's, on the CPU: every case
of tests/torch_zoo_cases.py in this group, f32 and with bf16 inputs,
and in training mode where the case keeps state; the harness
(tests/torch_zoo_harness.py) states what is compared and to what
tolerance."""
import pytest

import torch_zoo_harness as H
from torch_zoo_cases import CASES, group

MODES = [(name, mode) for name in group("pool_norm")
         for mode in (("f32", "bf16") if CASES[name].bf16 else ("f32",))
         + (("train",) if CASES[name].train else ())]


@pytest.mark.parametrize("name,mode", MODES,
                         ids=[f"{n}-{m}" for n, m in MODES])
def test_layer_against_jax(name, mode):
    H.run(name, "bfloat16" if mode == "bf16" else "float32",
          training=mode == "train")
