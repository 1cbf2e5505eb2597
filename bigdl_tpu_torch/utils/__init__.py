"""Utilities of the port."""
from bigdl_tpu_torch.utils.convert import (export_variables, flatten,
                                           load_jax_variables,
                                           random_variables)

__all__ = ["export_variables", "flatten", "load_jax_variables",
           "random_variables"]
